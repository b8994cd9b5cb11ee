"""Device resolution (counterpart of mxnet_tpu/context.py).

Every entry point of this package runs on the CUDA card unless the
caller asks for the CPU. There is no quiet fallback: asking for the
default device on a machine without CUDA raises `DeviceUnreachable`.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["DeviceUnreachable", "cpu", "gpu", "resolve_device"]


class DeviceUnreachable(MXNetError):
    """The requested device does not exist on this machine."""


def resolve_device(device=None):
    """`None` -> the first CUDA device; ``"cpu"``/``"cuda[:N]"`` or a
    `torch.device` as given. Raises `DeviceUnreachable` for a CUDA
    device that is not there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError("device must be 'cuda[:N]' or 'cpu', got %r"
                         % (device,))
    if not torch.cuda.is_available():
        raise DeviceUnreachable(
            "no CUDA device on this machine; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise DeviceUnreachable("cuda:%d requested, %d device(s) present"
                                % (index, torch.cuda.device_count()))
    return torch.device("cuda", index)


def cpu(device_id=0):
    """MXNet's ``mx.cpu()``: the CPU, as a torch device."""
    return torch.device("cpu")


def gpu(device_id=0):
    """MXNet's ``mx.gpu(i)``: CUDA device `i`, as a torch device."""
    return torch.device("cuda", device_id)
