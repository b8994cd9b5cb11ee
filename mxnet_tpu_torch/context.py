"""Device contexts (counterpart of mxnet_tpu/context.py).

A `Context` names a device as MXNet does (``cpu(0)``, ``gpu(i)``), with
equality, hashing and ``with ctx:`` scoping; `torch_device` is the torch
device it stands for, as the JAX package's `jax_device` is the jax one.

Every entry point of this package runs on the CUDA card unless the
caller asks for the CPU. So the default context is ``gpu(0)``, where the
JAX package's is ``cpu(0)`` (context.py:74-79): ``nd.array(x)`` without a
ctx goes to the card, and raises `DeviceUnreachable` on a machine without
one. ``with mx.cpu():`` (or ``ctx=mx.cpu()``) selects the CPU. There is
no quiet fallback.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "DeviceUnreachable", "cpu", "current_context", "gpu",
           "num_gpus", "resolve_device"]

_local = threading.local()


class DeviceUnreachable(MXNetError):
    """The requested device does not exist on this machine, or did not
    answer within a watchdog's deadline (`resilience.watchdog`). The
    message carries the lease-holder diagnostics when a watchdog has
    them; `.diagnostics` holds the dump alone for machine consumers."""

    def __init__(self, msg, diagnostics=None):
        super().__init__(msg + ("\n" + diagnostics if diagnostics else ""))
        self.diagnostics = diagnostics


class Context:
    """A device context: `device_type` 'cpu' or 'gpu' ('cuda' is taken as
    'gpu'), and `device_id`."""

    devtype2mask = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type == "cuda":
            device_type = "gpu"
        if device_type not in self.devtype2mask:
            raise MXNetError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctx = []

    @property
    def torch_device(self):
        """The torch device; raises `DeviceUnreachable` for a card that is
        not there."""
        if self.device_type == "gpu":
            return resolve_device(torch.device("cuda", self.device_id))
        return torch.device("cpu")

    def is_accelerator(self):
        return self.device_type == "gpu"

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        self._old_ctx.append(getattr(_local, "default_ctx", None))
        _local.default_ctx = self
        return self

    def __exit__(self, *exc):
        _local.default_ctx = self._old_ctx.pop()
        return False

    @classmethod
    def default_ctx(cls):
        ctx = getattr(_local, "default_ctx", None)
        return cls("gpu", 0) if ctx is None else ctx


def context_of(device):
    """The `Context` of a torch device."""
    device = torch.device(device)
    if device.type == "cuda":
        return Context("gpu", 0 if device.index is None else device.index)
    return Context("cpu", 0)


def resolve_device(device=None):
    """`None` -> the current context's device (the first CUDA device
    unless a ``with mx.cpu():`` scope says otherwise); a `Context`,
    ``"cpu"``/``"cuda[:N]"`` or a `torch.device` as given. Raises
    `DeviceUnreachable` for a CUDA device that is not there."""
    if device is None:
        device = Context.default_ctx()
    if isinstance(device, Context):
        if device.device_type != "gpu":
            return torch.device("cpu")
        device = torch.device("cuda", device.device_id)
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError("device must be 'cuda[:N]' or 'cpu', got %r"
                         % (device,))
    if not torch.cuda.is_available():
        raise DeviceUnreachable(
            "no CUDA device on this machine; pass device='cpu' (or "
            "ctx=mx.cpu(), or work inside `with mx.cpu():`) to run the "
            "plain PyTorch path on the CPU")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise DeviceUnreachable("cuda:%d requested, %d device(s) present"
                                % (index, torch.cuda.device_count()))
    return torch.device("cuda", index)


def cpu(device_id=0):
    """MXNet's ``mx.cpu()``."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """MXNet's ``mx.gpu(i)``: CUDA device `i`."""
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    return Context.default_ctx()
