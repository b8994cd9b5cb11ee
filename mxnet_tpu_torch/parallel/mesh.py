"""Device meshes over the port's devices, and the collectives over their
axes (counterpart of mxnet_tpu/parallel/mesh.py: `shard_map_compat` :30,
`make_mesh` :47, `data_parallel_mesh` :78, `replica_devices` :86,
`replicated` :99, `shard_on` :104, `put_sharded` :117,
`current_mesh`/`use_mesh` :125-137; the axis helpers are the port's
analogs of ``lax.axis_index``, ``lax.psum``, ``lax.pmean`` and
``lax.all_gather``).

A `Mesh` lays devices out on named axes ('dp' data parallel, 'tp' tensor
parallel, 'pp' pipeline stages, 'sp' sequence); a `PartitionSpec` names,
for each dimension of a tensor, the mesh axis (or axes) it is split over,
None for none; a `NamedSharding` is the pair. Trainers read them: a
`ShardedTrainer` checks its `param_rules` and `input_specs` against the
mesh's axes.

Two kinds of mesh:

- **Across processes.** When a process group is up
  (`parallel.kvstore_dist.init_distributed`, one process a card as
  ``tools/launch.py -n N`` starts them, PyTorch's idiom), `make_mesh`
  without `devices` lays the gang's ranks on the axes in rank order, one
  device a rank (`kvstore_dist.rank_device`). The mesh knows this rank's
  own device (`device`), its index on each axis (`axis_index`) and, for
  each axis, the process group of the ranks that differ only along it
  (`group`); `make_mesh` makes those groups, so every rank of the gang
  calls it alike. An axis over the whole gang uses the default group.
- **Local.** Without a process group, or with `devices` given, the mesh
  is over this process's devices: the current context's (the CUDA cards,
  or the CPU under ``with mx.cpu():``). One device gives ``{"dp": 1}``
  and its collectives are identities. One process driving several cards
  is not ported: `device` (and so `put_sharded` and a trainer) raises
  for a local mesh of more than one device, naming tools/launch.py.

`shard_map_compat(f, mesh, in_specs, out_specs)` runs `f` on this rank's
shard: an argument split by its spec is cut to the rank's block (every
rank passes the whole value, as a JAX global array holds it), a
replicated one (``PartitionSpec()``) is passed as this rank has it;
inside `f` the axis helpers reach the mesh's groups; a ``PartitionSpec()``
output is returned whole and a split one as the rank's local shard (there
is no global tensor to assemble). As with ``check_vma=False``, nothing
checks that a replicated output agrees across ranks.

The collectives reduce in place on NCCL, or on gloo in host memory (a CUDA
tensor goes to the host and back). NCCL's are captured by a CUDA graph;
gloo's cannot be, and raise inside a capture. `pmean` is differentiable:
its backward is the `pmean` of the incoming gradient.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, resolve_device

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "all_gather",
           "axis_index", "current_mesh", "data_parallel_mesh", "make_mesh",
           "pmean", "psum", "put_sharded", "replica_devices", "replicated",
           "shard_map_compat", "shard_on", "use_mesh"]

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
    `torch.device` whose shape gives each axis's size. A mesh across
    processes also holds ``ranks`` (the gang's rank at each position),
    this process's `rank` and the process group of each axis."""

    def __init__(self, devices, axis_names, ranks=None, rank=None,
                 groups=None):
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
        self.ranks = None if ranks is None else \
            np.asarray(ranks, dtype=np.int64).reshape(devices.shape)
        self.rank = rank
        self._groups = dict(groups or {})

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def spans_processes(self):
        """Whether the mesh is laid over a gang of processes."""
        return self.ranks is not None

    @property
    def device(self):
        """This process's device: its rank's on a mesh across processes,
        the one device of a local one-device mesh."""
        if self.spans_processes:
            return self.devices[self._coords()]
        if self.size != 1:
            raise MXNetError(
                "a mesh over %d devices (%s) in one process: one process "
                "driving several cards is not ported; start one process a "
                "card (python tools/launch.py -n %d python train.py) and "
                "make the mesh in each" % (self.size, self.shape, self.size))
        return self.devices.flat[0]

    def _coords(self):
        return tuple(int(c[0]) for c in np.nonzero(self.ranks == self.rank))

    def axis_index(self, name):
        """This rank's index along axis `name` (0 on a local mesh)."""
        if name not in self.shape:
            raise MXNetError("axis %r is not an axis of the mesh %s"
                             % (name, self.shape))
        if not self.spans_processes:
            return 0
        return self._coords()[self.axis_names.index(name)]

    def group(self, name):
        """The process group of axis `name` that holds this rank (None on
        a local mesh: its collectives are identities)."""
        if name not in self.shape:
            raise MXNetError("axis %r is not an axis of the mesh %s"
                             % (name, self.shape))
        return self._groups.get(name)

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
                list(other.devices.flat) and
                (self.ranks is None) == (other.ranks is None) and
                (self.ranks is None or
                 np.array_equal(self.ranks, other.ranks)))

    def __repr__(self):
        if self.spans_processes:
            return "Mesh(%s, ranks=%s, rank=%d)" % (
                self.shape, self.ranks.reshape(-1).tolist(), self.rank)
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


def _axis_sizes(axes, n):
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
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
    return names, sizes


def _gang():
    """(world size, rank) of the process group, or None without one."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_world_size(), dist.get_rank()


def _process_mesh(axes, world, rank):
    """The gang's ranks on `axes`, in rank order, with a process group per
    axis. Every rank makes every group, in one order (torch.distributed's
    rule for `new_group`)."""
    import torch.distributed as dist
    from .kvstore_dist import rank_device
    if axes is None:
        axes = {"dp": world}
    names, sizes = _axis_sizes(axes, world)
    if math.prod(sizes) != world:
        raise ValueError("mesh %s covers %d ranks, the gang has %d: a mesh "
                         "across processes takes every rank"
                         % (dict(zip(names, sizes)), math.prod(sizes),
                            world))
    ranks = np.arange(world).reshape(sizes)
    devices = np.empty(world, dtype=object)
    devices[:] = [rank_device(r) for r in range(world)]
    groups = {}
    for i, name in enumerate(names):
        rows = np.moveaxis(ranks, i, -1).reshape(-1, sizes[i])
        for row in rows:
            row = [int(r) for r in row]
            if len(row) == world:
                group = dist.group.WORLD
            else:
                group = dist.new_group(row)
            if rank in row:
                groups[name] = group
    return Mesh(devices.reshape(sizes), tuple(names), ranks=ranks,
                rank=rank, groups=groups)


def make_mesh(axes=None, devices=None):
    """A Mesh from ``{axis_name: size}``. One size may be -1, filled with
    what is left. Defaults to everything on one 'dp' axis. Axis order
    follows the dict's.

    Without `devices`, inside a process group: the gang's ranks, one
    device a rank, every rank on the mesh (module note); every rank
    calls this alike. Otherwise over `devices` (default: the current
    context's), in this process."""
    gang = _gang() if devices is None else None
    if gang is not None:
        return _process_mesh(axes, *gang)
    devices = [resolve_device(d) for d in (
        devices if devices is not None else _local_devices())]
    n = len(devices)
    if axes is None:
        axes = {"dp": n}
    names, sizes = _axis_sizes(axes, n)
    total = math.prod(sizes)
    if total > n:
        raise ValueError("mesh %s needs %d devices but only %d available"
                         % (dict(zip(names, sizes)), total, n))
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(sizes), axis_names=tuple(names))


def data_parallel_mesh(n=None):
    """All (or the first n) local devices on one 'dp' axis."""
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
    """`x` (a tensor, NDArray or array, the whole value) placed with
    `sharding`: on this process's device, cut to this rank's block where
    the spec splits it (on a one-device mesh, a copy of the whole). An
    NDArray stays one. A local mesh of more than one device raises."""
    from ..ndarray import NDArray
    mesh = sharding.mesh
    dev = mesh.device
    wrap = isinstance(x, NDArray)
    if wrap:
        x = x._data
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    x = local_block(mesh, sharding.spec, x).to(dev)
    return NDArray(x) if wrap else x


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


# -- blocks of a split value --------------------------------------------------
def _parts(part):
    return part if isinstance(part, tuple) else (part,)


def local_block(mesh, spec, x):
    """This rank's block of the whole value `x` under `spec`: each
    dimension the spec splits is cut into as many equal blocks as its
    axes' sizes multiply to, and the block at this rank's (row-major)
    index over those axes is kept. A view where it can be."""
    for dim, part in enumerate(spec):
        if part is None:
            continue
        ways, index = 1, 0
        for axis in _parts(part):
            size = mesh.shape[axis]
            ways, index = ways * size, index * size + mesh.axis_index(axis)
        if ways == 1:
            continue
        if dim >= x.dim() or x.shape[dim] % ways:
            raise MXNetError("a value of shape %s cannot split dim %d %d "
                             "ways" % (tuple(x.shape), dim, ways))
        k = x.shape[dim] // ways
        x = x.narrow(dim, index * k, k)
    return x


# -- the collectives ----------------------------------------------------------
_SCOPES = []


def _mesh_for(mesh):
    mesh = mesh if mesh is not None else (
        _SCOPES[-1] if _SCOPES else current_mesh())
    if mesh is None:
        raise MXNetError("no mesh: pass one, or call inside "
                         "shard_map_compat or use_mesh")
    return mesh


def _staged(t, group):
    """Whether `group`'s backend reduces in host memory for `t` (gloo and
    a CUDA tensor). Raises inside a CUDA graph capture, which gloo's host
    round trip cannot join."""
    import torch.distributed as dist
    if not t.is_cuda or dist.get_backend(group) != "gloo":
        return False
    if torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            "a gloo collective cannot run inside a CUDA graph capture; "
            "train over gloo with MXTPU_CUDA_GRAPH=0 (or over nccl)")
    return True


def all_reduce_(t, group):
    """In-place SUM of `t` over `group` (None: nothing to do)."""
    if group is None:
        return t
    import torch.distributed as dist
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


def reduce_scatter_(out, t, group):
    """`out` := this rank's block of the SUM over `group` of `t` (each
    rank's `t`, raveled, is as many equal blocks as the group has ranks,
    in rank order; `out` takes one block's shape)."""
    if group is None:
        return out.copy_(t)
    import torch.distributed as dist
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    src = t.reshape(-1)
    if _staged(t, group):
        host = torch.empty(out.numel(), dtype=out.dtype)
        fn(host, src.cpu(), group=group)
        return out.copy_(host.view(out.shape))
    if out.is_contiguous():
        fn(out.view(-1), src.contiguous(), group=group)
        return out
    flat = torch.empty(out.numel(), dtype=out.dtype, device=out.device)
    fn(flat, src.contiguous(), group=group)
    return out.copy_(flat.view(out.shape))


def all_gather_(out, t, group):
    """`out` := every rank's `t`, raveled and concatenated in rank order
    (`out` of any shape of that many elements)."""
    if group is None:
        return out.copy_(t)
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    src = t.reshape(-1)
    if _staged(t, group):
        host = torch.empty(out.numel(), dtype=out.dtype)
        fn(host, src.cpu(), group=group)
        return out.copy_(host.view(out.shape))
    if out.is_contiguous():
        fn(out.view(-1), src.contiguous(), group=group)
        return out
    flat = torch.empty(out.numel(), dtype=out.dtype, device=out.device)
    fn(flat, src.contiguous(), group=group)
    return out.copy_(flat.view(out.shape))


def axis_index(axis_name, mesh=None):
    """This rank's index along `axis_name` (``lax.axis_index``)."""
    return _mesh_for(mesh).axis_index(axis_name)


def psum(x, axis_name, mesh=None):
    """The SUM of `x` over the ranks of `axis_name` (``lax.psum``); no
    gradient."""
    mesh = _mesh_for(mesh)
    return all_reduce_(x.detach().clone(), mesh.group(axis_name))


class _PMean(torch.autograd.Function):
    """pmean with its transpose as backward: the incoming gradients'
    mean over the axis."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return all_reduce_(x.detach().clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group) / ctx.n, \
            None, None


def pmean(x, axis_name, mesh=None):
    """The mean of `x` over the ranks of `axis_name` (``lax.pmean``),
    differentiable: its backward is the pmean of the incoming gradient.
    The division is by the axis size, after the sum."""
    mesh = _mesh_for(mesh)
    group = mesh.group(axis_name)
    n = mesh.shape[axis_name]
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _PMean.apply(x, group, n)
    return all_reduce_(x.detach().clone(), group) / n


def all_gather(x, axis_name, mesh=None, axis=0, tiled=False):
    """Every rank's `x` along `axis_name`, in rank order
    (``lax.all_gather``): stacked on a new dim `axis`, or concatenated
    along `axis` with ``tiled=True``. No gradient."""
    mesh = _mesh_for(mesh)
    n = mesh.shape[axis_name]
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    all_gather_(out, x.detach(), mesh.group(axis_name))
    if tiled:
        return torch.cat(list(out.unbind(0)), dim=axis)
    return out.movedim(0, axis) if axis else out


# -- shard_map ----------------------------------------------------------------
def _map_specs(spec, tree, fn):
    """`fn(spec, leaf)` over `tree` (nested dicts, lists and tuples of
    tensors); `spec` a PartitionSpec (or None) for the whole subtree, or a
    tree of them of `tree`'s structure."""
    if spec is None or isinstance(spec, PartitionSpec):
        if isinstance(tree, dict):
            return {k: _map_specs(spec, v, fn) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_map_specs(spec, v, fn) for v in tree)
        return fn(spec or PartitionSpec(), tree)
    if isinstance(tree, dict):
        return {k: _map_specs(spec[k], v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and isinstance(spec, (list, tuple)) \
            and not isinstance(spec, PartitionSpec):
        if len(spec) != len(tree):
            raise MXNetError("shard_map_compat: %d specs for %d values"
                             % (len(spec), len(tree)))
        return type(tree)(_map_specs(s, v, fn) for s, v in zip(spec, tree))
    raise MXNetError("shard_map_compat: a spec %r for a %s"
                     % (spec, type(tree).__name__))


def shard_map_compat(f, mesh, in_specs, out_specs):
    """`f` run on this rank's shard of its arguments (module note):
    ``in_specs`` one spec tree per argument, ``out_specs`` the outputs'.
    The axis helpers inside `f` use `mesh`."""
    _map_specs(out_specs, out_specs, lambda s, _: mesh.check_spec(
        s, "shard_map_compat out_specs"))

    def run(*args):
        specs = in_specs if isinstance(in_specs, (list, tuple)) and \
            not isinstance(in_specs, PartitionSpec) else (in_specs,)
        if len(specs) != len(args):
            raise MXNetError("shard_map_compat: %d in_specs for %d "
                             "arguments" % (len(specs), len(args)))

        def cut(spec, x):
            if not isinstance(x, torch.Tensor):
                return x
            return local_block(mesh, mesh.check_spec(
                spec, "shard_map_compat in_specs"), x)
        local = [_map_specs(s, a, cut) for s, a in zip(specs, args)]
        _SCOPES.append(mesh)
        try:
            return f(*local)
        finally:
            _SCOPES.pop()
    return run
