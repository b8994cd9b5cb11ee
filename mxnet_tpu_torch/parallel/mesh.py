"""Device meshes over the port's devices (counterpart of
mxnet_tpu/parallel/mesh.py: `make_mesh` :47, `data_parallel_mesh` :78,
`replica_devices` :86, `replicated` :99, `shard_on` :104, `put_sharded`
:117, `current_mesh`/`use_mesh` :125-137).

A `Mesh` lays devices out on named axes ('dp' data parallel, 'tp' tensor
parallel, 'pp' pipeline stages, 'sp' sequence); a `PartitionSpec` names,
for each dimension of a tensor, the mesh axis (or axes) it is split over,
None for none; a `NamedSharding` is the pair. Trainers read them: a
`ShardedTrainer` checks its `param_rules` and `input_specs` against the
mesh's axes.

The devices are the current context's: the CUDA cards, or the CPU under
``with mx.cpu():`` (or ``devices=["cpu"]``), one CPU device. One card
gives ``{"dp": 1}``. Placing data on a mesh of more than one device is
one process driving several cards, which is not ported (ROADMAP A6c, as
is `shard_map_compat`): `put_sharded` raises there.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, resolve_device

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "make_mesh",
           "data_parallel_mesh", "replica_devices", "replicated", "shard_on",
           "put_sharded", "current_mesh", "use_mesh"]

_ACTIVE = []


class PartitionSpec(tuple):
    """Per tensor dimension, the mesh axis name it is split over, a tuple
    of names, or None (not split); dimensions past its end are not
    split. ``PartitionSpec()`` replicates."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)

    def axes(self):
        """Every mesh axis name the spec uses."""
        out = []
        for p in self:
            if p is None:
                continue
            out.extend(p if isinstance(p, tuple) else (p,))
        return out


class Mesh:
    """Devices laid out on named axes: ``devices`` an object array of
    `torch.device` whose shape gives each axis's size."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise MXNetError("Mesh: %d axis names for a %d-d device array"
                             % (len(axis_names), devices.ndim))
        if len(set(axis_names)) != len(axis_names):
            raise MXNetError("Mesh: repeated axis names %s" % (axis_names,))
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def device(self):
        """The one device of a one-device mesh."""
        if self.size != 1:
            raise MXNetError(
                "a mesh over %d devices (%s): one process over several "
                "cards is not ported (ROADMAP A6c)" % (self.size, self.shape))
        return self.devices.flat[0]

    def check_spec(self, spec, what):
        """`spec` (a PartitionSpec or a tuple) as a PartitionSpec; raises
        unless every axis it names is one of this mesh's."""
        spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        missing = [a for a in spec.axes() if a not in self.axis_names]
        if missing:
            raise MXNetError("%s: axis %s is not an axis of the mesh %s"
                             % (what, missing[0], self.shape))
        return spec

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.axis_names ==
                other.axis_names and self.devices.shape ==
                other.devices.shape and list(self.devices.flat) ==
                list(other.devices.flat))

    def __repr__(self):
        return "Mesh(%s, devices=%s)" % (
            self.shape, [str(d) for d in self.devices.flat])


class NamedSharding:
    """A tensor's layout on a mesh: `spec` over `mesh`'s axes."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, mesh.check_spec(spec, "NamedSharding")

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def _local_devices():
    """The current context's devices: every CUDA card, or the CPU under
    an ``mx.cpu()`` context (raises `DeviceUnreachable` without a card
    otherwise)."""
    if Context.default_ctx().device_type == "cpu":
        return [torch.device("cpu")]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes=None, devices=None):
    """A Mesh from ``{axis_name: size}`` over `devices` (default: the
    current context's). One size may be -1, filled with the devices
    left. Defaults to every device on one 'dp' axis. Axis order follows
    the dict's."""
    devices = [resolve_device(d) for d in (
        devices if devices is not None else _local_devices())]
    if axes is None:
        axes = {"dp": len(devices)}
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    n = len(devices)
    if sizes.count(-1) > 1:
        raise ValueError("make_mesh: at most one axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if known < 1 or n % known != 0:
            raise ValueError(
                "make_mesh: %d devices not divisible by fixed axes %s"
                % (n, dict(zip(names, sizes))))
        sizes[sizes.index(-1)] = n // known
    if any(s < 1 for s in sizes):
        raise ValueError("make_mesh: axis sizes must be positive, got %s"
                         % dict(zip(names, sizes)))
    total = math.prod(sizes)
    if total > n:
        raise ValueError("mesh %s needs %d devices but only %d available"
                         % (dict(zip(names, sizes)), total, n))
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(sizes), axis_names=tuple(names))


def data_parallel_mesh(n=None):
    """All (or the first n) devices on one 'dp' axis."""
    devices = _local_devices()
    if n is not None:
        devices = devices[:n]
    return make_mesh({"dp": len(devices)}, devices)


def replica_devices(n=None):
    """The local devices serving replicas bind to (the list `make_mesh`
    lays meshes over), capped at `n`; never cycles."""
    devices = _local_devices()
    if n is not None:
        devices = devices[:max(1, int(n))]
    return devices


def replicated(mesh):
    """Sharding that replicates across the whole mesh."""
    return NamedSharding(mesh, PartitionSpec())


def shard_on(mesh, axis_name, dim=0, ndim=None):
    """Sharding that splits tensor dim `dim` over mesh axis `axis_name`.
    Negative `dim` requires `ndim`."""
    if dim < 0:
        if ndim is None:
            raise ValueError("shard_on: negative dim requires ndim")
        dim = dim % ndim
    spec = [None] * (ndim if ndim is not None else dim + 1)
    spec[dim] = axis_name
    return NamedSharding(mesh, PartitionSpec(*spec))


def put_sharded(x, sharding):
    """`x` (a tensor, NDArray or array) placed with `sharding`: on a
    one-device mesh, a copy on that device (an NDArray stays one). A mesh
    of more than one device raises (ROADMAP A6c)."""
    from ..ndarray import NDArray
    dev = sharding.mesh.device
    if isinstance(x, NDArray):
        return NDArray(x._data.to(dev))
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(dev)


def current_mesh():
    """The innermost `use_mesh` scope's mesh, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextmanager
def use_mesh(mesh):
    """Scope a mesh as the active one (trainers made inside pick it up)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()
