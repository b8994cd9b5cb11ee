"""The port's meshes and input prefetcher (mxnet_tpu_torch/parallel/mesh.py,
mxnet_tpu_torch/parallel/prefetch.py), on the CPU, with JAX not imported.

Meshes: `make_mesh`'s shapes and errors (those of JAX's make_mesh), the
one-device default, scoping by `use_mesh`, shardings and their placement,
and the refusal of a local mesh of several devices (one process over
several cards; the error names tools/launch.py). The
prefetcher: the cases of JAX's tests/test_prefetch.py (:42-162), order,
run-ahead (the consumer 5x slower than the source), exception relay,
`close` joining its worker, depth below 1, and `stage_databatch`
returning a new batch; JAX's overlap test is left out, its bound being
within 2x of what it measures. One test runs on the card only (the
side stream and its event), and skips here.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import DeviceUnreachable, MXNetError, gluon
from mxnet_tpu_torch.io import DataBatch
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.parallel.mesh import (
    Mesh, NamedSharding, PartitionSpec, current_mesh, data_parallel_mesh,
    make_mesh, put_sharded, replica_devices, replicated, shard_on, use_mesh)
from mxnet_tpu_torch.parallel.prefetch import (DevicePrefetcher,
                                               stage_databatch, to_device)
from mxnet_tpu_torch.observability import registry

CPU = torch.device("cpu")


# -- meshes -------------------------------------------------------------------
@pytest.mark.parametrize("axes,shape", [
    (None, {"dp": 1}), ({"dp": 1}, {"dp": 1}), ({"dp": -1}, {"dp": 1}),
    ({"dp": 1, "tp": 1}, {"dp": 1, "tp": 1}),
    ({"dp": -1, "tp": 1}, {"dp": 1, "tp": 1})])
def test_make_mesh_shapes(axes, shape):
    with mx.cpu():
        mesh = make_mesh(axes)
    assert mesh.shape == shape and list(mesh.axis_names) == list(shape)
    assert mesh.size == 1 and mesh.device == CPU
    assert make_mesh(axes, devices=["cpu"]) == mesh


@pytest.mark.parametrize("axes,match", [
    ({"dp": -1, "tp": -1}, "at most one"),
    ({"dp": 2}, "needs 2 devices but only 1"),
    ({"dp": -1, "tp": 2}, "not divisible"),
    ({"dp": 0}, "positive")])
def test_make_mesh_errors(axes, match):
    with pytest.raises(ValueError, match=match):
        make_mesh(axes, devices=["cpu"])


def test_the_default_mesh_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (make_mesh, data_parallel_mesh, replica_devices):
        with pytest.raises(DeviceUnreachable):
            fn()
    with mx.cpu():
        assert data_parallel_mesh().shape == {"dp": 1}
        assert replica_devices(4) == [CPU]


def test_use_mesh_nests_and_restores():
    a = make_mesh({"dp": 1}, devices=["cpu"])
    b = make_mesh({"dp": 1, "tp": 1}, devices=["cpu"])
    assert current_mesh() is None
    with use_mesh(a) as m:
        assert m is a and current_mesh() is a
        with use_mesh(b):
            assert current_mesh() is b
        assert current_mesh() is a
    assert current_mesh() is None
    with pytest.raises(RuntimeError):
        with use_mesh(a):
            raise RuntimeError("inside")
    assert current_mesh() is None


def test_shardings_and_placement():
    mesh = make_mesh({"dp": 1, "tp": 1}, devices=["cpu"])
    assert replicated(mesh).spec == PartitionSpec()
    assert shard_on(mesh, "tp", dim=1).spec == PartitionSpec(None, "tp")
    assert shard_on(mesh, "dp", dim=-1, ndim=3).spec == \
        PartitionSpec(None, None, "dp")
    with pytest.raises(ValueError, match="ndim"):
        shard_on(mesh, "dp", dim=-1)
    with pytest.raises(MXNetError, match="sp"):
        NamedSharding(mesh, ("dp", "sp"))
    assert PartitionSpec(("dp", "tp"), None).axes() == ["dp", "tp"]
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = put_sharded(x, shard_on(mesh, "dp"))
    assert isinstance(t, torch.Tensor) and t.device == CPU
    assert np.array_equal(t.numpy(), x)
    nd = put_sharded(mx.nd.array(x, ctx=mx.cpu()), replicated(mesh))
    assert isinstance(nd, mx.nd.NDArray)


def test_a_mesh_of_several_devices_is_a6c():
    """A local mesh over more devices than one: its layout is kept, but
    placing data on it or training on it is one process over several
    cards, which stays unported: the error names tools/launch.py (one
    process a card, where the mesh spans the processes)."""
    mesh = make_mesh({"dp": 2}, devices=["cpu", "cpu"])
    assert isinstance(mesh, Mesh) and mesh.size == 2
    assert not mesh.spans_processes
    with pytest.raises(MXNetError, match="tools/launch.py"):
        put_sharded(np.zeros(2), replicated(mesh))
    net = gluon.nn.Dense(2, in_units=3, device="cpu")
    with pytest.raises(MXNetError, match="tools/launch.py"):
        ShardedTrainer(net, gluon.loss.L2Loss(), "sgd", mesh=mesh)


def test_a_trainer_takes_the_scoped_mesh():
    net = gluon.nn.Dense(2, in_units=3, device="cpu")
    mesh = make_mesh({"dp": 1, "tp": 1}, devices=["cpu"])
    with use_mesh(mesh):
        st = ShardedTrainer(net, gluon.loss.L2Loss(), "sgd")
    assert st._mesh is mesh and st._dev == CPU
    # a device beside the mesh must be the mesh's (here: no card at all)
    with pytest.raises(MXNetError, match="device"):
        ShardedTrainer(net, gluon.loss.L2Loss(), "sgd", mesh=mesh,
                       device="cuda")


# -- the prefetcher (JAX tests/test_prefetch.py) -------------------------------
class SlowSource:
    """Iterator that takes `delay` seconds per batch and records when
    each pull happened."""

    def __init__(self, n, delay, shape=(4, 8)):
        self.n, self.delay, self.shape = n, delay, shape
        self.pulled = []
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self.n:
            raise StopIteration
        time.sleep(self.delay)
        self.pulled.append((self._i, time.monotonic()))
        self._i += 1
        return (np.full(self.shape, self._i, np.float32),
                np.zeros((self.shape[0],), np.float32))


def test_prefetcher_orders_and_completes():
    out = list(DevicePrefetcher(SlowSource(6, 0.0), depth=2))
    assert [int(x[0][0, 0]) for x in out] == [1, 2, 3, 4, 5, 6]


def test_prefetcher_runs_ahead_of_consumer():
    """While the consumer works on batch k, the worker has already pulled
    batch k+1."""
    src = SlowSource(8, 0.01)
    seen = 0
    for k, _ in enumerate(DevicePrefetcher(src, depth=2)):
        time.sleep(0.05)            # the consumer 5x slower
        if k < 5:
            assert len(src.pulled) >= min(8, k + 2), (k, len(src.pulled))
        seen += 1
    assert seen == 8


def test_prefetcher_relays_exceptions_and_counts_waits():
    def bad():
        yield (np.zeros((2, 2), np.float32),)
        raise RuntimeError("decode exploded")

    waits = registry.histogram("io.batch_wait.seconds")
    n0 = waits.count()
    pf = DevicePrefetcher(bad(), depth=2)
    next(pf)
    with pytest.raises(RuntimeError, match="decode exploded"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    assert waits.count() == n0 + 2


def test_prefetcher_close_joins_its_worker():
    src = SlowSource(1000, 0.001)
    pf = DevicePrefetcher(src, depth=2)
    next(pf)
    assert pf.close() is True
    assert not pf._thread.is_alive()
    n_at_close = len(src.pulled)
    time.sleep(0.05)
    assert len(src.pulled) == n_at_close
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_depth_below_one_raises():
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher([], depth=0)


def test_prefetcher_stages_on_its_thread():
    """`stage` runs on the worker thread, not the consumer's."""
    threads = []

    def stage(item):
        threads.append(threading.get_ident())
        return item

    list(DevicePrefetcher(SlowSource(3, 0.0), stage, depth=1))
    assert len(threads) == 3 and threading.get_ident() not in threads


def test_stage_databatch_returns_a_new_batch():
    orig = mx.nd.array(np.ones((2, 3)), ctx=mx.cpu())
    b = DataBatch(data=[orig], label=[np.zeros((2,), np.float32)], pad=0)
    out = stage_databatch(b, device="cpu")
    assert out is not b and b.data[0] is orig
    assert isinstance(out.data[0], mx.nd.NDArray)
    assert isinstance(out.label[0], mx.nd.NDArray)
    assert out.data[0].shape == (2, 3) and out.pad == 0
    assert [o.pad for o in stage_databatch([b, b], device="cpu")] == [0, 0]
    assert stage_databatch("x", device="cpu") == "x"
    with mx.cpu():
        assert stage_databatch(b).data[0].context == mx.cpu()
    assert to_device(orig, CPU) is orig._data


@pytest.mark.cuda
def test_prefetcher_stages_on_a_side_stream_on_the_card():
    """On the card: staged through pinned memory on the prefetcher's own
    stream, and the consumer's stream waits for each batch's copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the side stream and its event")
    dev = torch.device("cuda", 0)
    streams = []

    def stage(item):
        streams.append(torch.cuda.current_stream(dev))
        return [to_device(x, dev) for x in item]

    src = SlowSource(4, 0.0, shape=(256, 1024))
    out = [x[0].sum().item() for x in DevicePrefetcher(src, stage, 2,
                                                       device=dev)]
    assert out == [256 * 1024 * float(i) for i in range(1, 5)]
    assert all(s != torch.cuda.current_stream(dev) for s in streams)


def test_shard_map_compat_and_the_axis_helpers_on_one_device():
    """On a local one-device mesh `shard_map_compat` passes whole values
    (every split is one block) and the axis helpers are identities:
    psum, pmean (with its gradient), all_gather (a new leading axis of 1,
    or tiled); axis_index 0. Outside a
    shard_map or use_mesh scope, a helper without a mesh raises. (Across
    processes: tests/test_torch_sharded_dist.py.)"""
    from mxnet_tpu_torch.parallel import mesh as M
    m = make_mesh({"dp": 1, "tp": 1}, devices=["cpu"])
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)

    def f(a, tree):
        assert M.axis_index("dp") == 0 and M.axis_index("tp") == 0
        g = M.all_gather(a, "dp")
        return {"sum": M.psum(a, "dp"), "mean": M.pmean(tree["w"], "tp"),
                "gathered": g, "tiled": M.all_gather(a, "dp", tiled=True)}
    out = M.shard_map_compat(
        f, m, (PartitionSpec("dp"), {"w": PartitionSpec()}),
        PartitionSpec())(x, {"w": x + 1})
    assert torch.equal(out["sum"], x) and torch.equal(out["mean"], x + 1)
    assert out["gathered"].shape == (1, 3, 2) and \
        torch.equal(out["gathered"][0], x)
    assert torch.equal(out["tiled"], x)
    a = torch.ones(2, requires_grad=True)
    with use_mesh(m):
        (M.pmean(a, "dp") * 3).sum().backward()
    assert a.grad.tolist() == [3.0, 3.0]
    with pytest.raises(MXNetError, match="no mesh"):
        M.psum(x, "dp")
    with pytest.raises(MXNetError, match="not an axis"):
        M.axis_index("sp", m)
    with pytest.raises(MXNetError, match="2 in_specs for 1"):
        M.shard_map_compat(f, m, (PartitionSpec(), PartitionSpec()),
                           PartitionSpec())(x)
    assert not m.spans_processes and m.group("dp") is None
    assert torch.equal(M.local_block(m, PartitionSpec("dp", "tp"), x), x)
