"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, and its entry points run on CUDA or raise — they never
fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import DeviceUnreachable, resolve_device
from mxnet_tpu_torch.convert import init_gpt_params
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import GPTDecoder
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1, resnet50_v1
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.serving import DecodeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")


def _forbidden(module):
    """jax / jaxlib, and mxnet_tpu itself or any mxnet_tpu.* — but not
    mxnet_tpu_torch, which shares the prefix."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "mxnet_tpu")


def test_forbidden_matches_the_right_prefix():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("mxnet_tpu") and _forbidden("mxnet_tpu.serving")
    assert not _forbidden("mxnet_tpu_torch")
    assert not _forbidden("mxnet_tpu_torch.serving.decode")


def test_import_pulls_in_no_jax_and_no_jax_package():
    """A fresh interpreter imports the port (every module of it) with
    imports of JAX and of mxnet_tpu blocked, then checks sys.modules."""
    code = r"""
import importlib, pkgutil, sys
BLOCK = ("jax", "jaxlib", "mxnet_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import of " + name)
for m in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import mxnet_tpu_torch
for info in pkgutil.walk_packages(mxnet_tpu_torch.__path__,
                                  "mxnet_tpu_torch."):
    importlib.import_module(info.name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)
print("BAD", bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_distributed_training_imports_no_jax(tmp_path):
    """With JAX and the JAX package blocked, a one-process gloo group on
    the CPU: `mx.kv.create("dist_sync")` joins it through the launcher's
    environment, pushes and pulls, and a Trainer over it takes the fused
    step; the bucketing and compression modules run too."""
    code = r"""
import socket, sys
BLOCK = ("jax", "jaxlib", "mxnet_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import of " + name)
for m in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import os
s = socket.socket(); s.bind(("127.0.0.1", 0))
os.environ.update(JAX_COORDINATOR_ADDRESS="127.0.0.1:%d"
                  % s.getsockname()[1], JAX_NUM_PROCESSES="1",
                  JAX_PROCESS_ID="0")
s.close()
import torch
import torch.distributed as dist
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gradient_compression import GradientCompression
from mxnet_tpu_torch.parallel import bucketing, fused_step
try:
    with mx.cpu():
        kv = mx.kv.create("dist_sync")
        assert dist.get_backend() == "gloo" and kv.num_workers == 1
        kv.init("w", torch.zeros(3))
        kv.push("w", [torch.ones(3), torch.ones(3)])
        out = torch.zeros(3)
        kv.pull("w", out=out)
        assert out.tolist() == [2.0, 2.0, 2.0]
        net = gluon.nn.Dense(2, in_units=3)
        net.initialize()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore=kv)
        with autograd.record():
            loss = net(torch.ones(4, 3)).sum()
        loss.backward()
        tr.step(4)
        assert tr._updaters[0]._fused_step_owner is not None
    b = bucketing.GradBucketer(64).plan([(0, (3,), "float32", 0, False)])
    assert len(b) == 1
    gc = GradientCompression(threshold=0.5)
    assert gc.roundtrip(0, torch.tensor([0.7, -0.9, 0.1])).tolist() == \
        [0.5, -0.5, 0.0]
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)
print("BAD", bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _python_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    # the port's scripts, which run on the card
    tools = os.path.join(ROOT, "tools")
    for f in sorted(os.listdir(tools)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(tools, f)


def test_no_module_imports_jax_or_the_jax_package():
    offenders = []
    for path in _python_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += ["%s: %s" % (os.path.relpath(path, ROOT), n)
                          for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no card and no device="cpu", the engine, the models and the
    trainer raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(vocab_size=16, max_seq_len=8, num_layers=1, num_heads=1,
               embed_dim=8, mlp_ratio=4)
    params = init_gpt_params(dict(cfg, head_dim=8, mlp_hidden=32), seed=0)
    with pytest.raises(DeviceUnreachable):
        resolve_device()
    with pytest.raises(DeviceUnreachable):
        GPTDecoder(params=params, **cfg)
    blk = GPTDecoder(params=params, device="cpu", **cfg)
    with pytest.raises(DeviceUnreachable):
        DecodeEngine(blk)
    with pytest.raises(DeviceUnreachable):
        resnet50_v1(layout="NHWC")
    net = resnet18_v1(classes=4, layout="NHWC", device="cpu")
    with pytest.raises(DeviceUnreachable):
        ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9},
                       compute_dtype="bfloat16")
    # asked for explicitly, the CPU runs
    eng = DecodeEngine(blk, max_slots=1, device="cpu")
    assert isinstance(eng.prefill(np.array([1, 2]), 0), int)
    assert resolve_device("cpu") == torch.device("cpu")
    st = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                        {"learning_rate": 0.1}, device="cpu")
    loss = st.step(torch.zeros(2, 16, 16, 3), torch.tensor([0.0, 1.0]))
    assert loss.device.type == "cpu" and torch.isfinite(loss)


def test_gluon_loop_entry_points_raise_without_cuda(monkeypatch):
    """The Gluon loop's entry points: a layer or net made, or a parameter
    moved, without device="cpu" raises when there is no card; asked for
    the CPU, record -> backward -> Trainer.step runs there. The
    distributed kvstore is the same: on the card, or on the CPU when
    asked; 'dist_async' is the synchronous store under that name."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnreachable):
        gluon.nn.Dense(2, in_units=3)
    with pytest.raises(DeviceUnreachable):
        gluon.nn.BatchNorm(in_channels=3)
    net = resnet18_v1(classes=4, layout="NHWC", device="cpu")
    with pytest.raises(DeviceUnreachable):
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(torch.randn(2, 16, 16, 3)),
                                         torch.tensor([0.0, 1.0]))
    loss.backward()
    trainer.step(2)
    assert loss.context == mx.cpu() and np.isfinite(loss.asnumpy()).all()
    with pytest.raises(DeviceUnreachable):
        mx.kvstore.create("dist_sync")
    with mx.cpu():
        kv = mx.kvstore.create("dist_sync")
    assert kv.device == torch.device("cpu") and kv.num_workers == 1
    with pytest.raises(DeviceUnreachable):
        mx.kvstore.create("dist_async")
    with mx.cpu():
        kv = mx.kvstore.create("dist_async")
    assert kv.type == "dist_async" and kv.device == torch.device("cpu")
    assert kv.num_workers == 1


def test_nd_default_context_is_the_card_and_raises_without_one(monkeypatch):
    """mx.nd's default context is gpu(0): without a card, creating an
    array with no ctx raises DeviceUnreachable (no quiet CPU fallback);
    `with mx.cpu():` or ctx=mx.cpu() selects the CPU."""
    import mxnet_tpu_torch as mx
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mx.current_context() == mx.gpu(0)
    for make in (lambda: mx.nd.array([1.0, 2.0]),
                 lambda: mx.nd.zeros((2, 2)),
                 lambda: mx.nd.random.uniform(shape=(2,)),
                 lambda: mx.nd.arange(3)):
        with pytest.raises(DeviceUnreachable):
            make()
    with pytest.raises(DeviceUnreachable):
        mx.gpu(0).torch_device
    a = mx.nd.array([1.0, 2.0], ctx=mx.cpu())
    assert a.context == mx.cpu()
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        b = mx.nd.ones((2,)) + a
        assert b.context == mx.cpu() and b.asnumpy().tolist() == [2.0, 3.0]
    assert mx.current_context() == mx.gpu(0)


def test_symbolic_layer_runs_with_jax_blocked():
    """mx.sym, mx.mod and mx.io in a fresh interpreter with imports of JAX
    and of mxnet_tpu blocked: a symbol built, a Module bound and trained a
    step on the CPU from an NDArrayIter, a hybridized block exported and
    imported back."""
    code = r"""
import os, sys, tempfile
BLOCK = ("jax", "jaxlib", "mxnet_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import of " + name)
for m in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import numpy as np
import mxnet_tpu_torch as mx
with mx.cpu():
    data = mx.sym.var("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(data, num_hidden=3,
                                                     name="fc"),
                               name="softmax")
    it = mx.io.NDArrayIter(np.ones((4, 5), np.float32),
                           np.zeros(4, np.float32), batch_size=2)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1})
    assert np.isfinite(mod.predict(it).asnumpy()).all()
    blk = mx.gluon.nn.Dense(2, in_units=5)
    blk.initialize(ctx=mx.cpu())
    blk.hybridize()
    y = blk(mx.nd.ones((1, 5)))
    tmp = tempfile.mkdtemp()
    blk.export(os.path.join(tmp, "d"))
    back = mx.gluon.SymbolBlock.imports(os.path.join(tmp, "d-symbol.json"),
                                        "data", os.path.join(tmp,
                                                             "d-0000.params"),
                                        ctx=mx.cpu())
    assert np.array_equal(back(mx.nd.ones((1, 5))).asnumpy(), y.asnumpy())
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)
print("BAD", bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_module_binds_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Module's default context is the card: without one, bind raises
    DeviceUnreachable; context=mx.cpu() binds on the CPU."""
    import mxnet_tpu_torch as mx
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    mod = mx.mod.Module(net, label_names=None)
    with pytest.raises(DeviceUnreachable):
        mod.bind([("data", (2, 4))])
    mod = mx.mod.Module(net, label_names=None, context=mx.cpu())
    mod.bind([("data", (2, 4))])
    assert mod._exec_group.exec_.arg_dict["data"].context == mx.cpu()


def test_sharded_trainer_api_runs_with_jax_blocked():
    """parallel.mesh, parallel.prefetch and ShardedTrainer's API in a fresh
    interpreter with imports of JAX and of mxnet_tpu blocked: a mesh, a
    trainer on it (Adam, remat, a parameter rule), and `fit` over an
    NDArrayIter through the prefetcher, on the CPU."""
    code = r"""
import sys
BLOCK = ("jax", "jaxlib", "mxnet_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import of " + name)
for m in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.parallel import mesh, prefetch
from mxnet_tpu_torch.parallel import ShardedTrainer
with mx.cpu():
    m = mesh.make_mesh({"dp": 1, "tp": 1})
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, activation="relu", in_units=5),
            mx.gluon.nn.Dense(3, in_units=8))
    net.initialize(ctx=mx.cpu())
    st = ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                        {"learning_rate": 0.01}, mesh=m, remat=True,
                        param_rules=[("dense0_weight", ("tp",))])
    it = mx.io.NDArrayIter(np.random.RandomState(0).randn(12, 5)
                           .astype(np.float32),
                           (np.arange(12) % 3).astype(np.float32),
                           batch_size=4)
    loss = st.fit(it, num_epochs=2)
    assert np.isfinite(float(loss)) and int(st.opt_state["t"]) == 6
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)
print("BAD", bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sharded_trainer_across_processes_runs_with_jax_blocked(tmp_path):
    """With JAX and the JAX package blocked, a one-process gloo group on
    the CPU: a ShardedTrainer over the gang's mesh (its collectives run
    at world size 1) with global-batch BatchNorm and ZeRO-1, a compressed
    one, a TrainerCheckpoint save and restore with its telemetry record,
    `shard_map_compat` and the axis helpers, and the chaos spec parser."""
    code = r"""
import json, os, socket, sys
BLOCK = ("jax", "jaxlib", "mxnet_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import of " + name)
for m in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import numpy as np, torch, torch.distributed as dist
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.parallel import ShardedTrainer, mesh
from mxnet_tpu_torch.parallel.checkpoint import TrainerCheckpoint
from mxnet_tpu_torch.parallel.kvstore_dist import init_distributed
from mxnet_tpu_torch.resilience import chaos
tmp = sys.argv[1]
os.environ["MXTPU_TELEMETRY"] = os.path.join(tmp, "t.jsonl")
s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]
s.close()
try:
    with mx.cpu():
        init_distributed("127.0.0.1:%d" % port, 1, 0)
        m = mesh.make_mesh()
        assert m.spans_processes and m.shape == {"dp": 1}
        f = mesh.shard_map_compat(lambda x: mesh.psum(x, "dp"), m,
                                  (mesh.PartitionSpec("dp"),),
                                  mesh.PartitionSpec())
        assert f(torch.ones(2)).tolist() == [1.0, 1.0]
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(8, in_units=5),
                mx.gluon.nn.BatchNorm(in_channels=8),
                mx.gluon.nn.Dense(3, in_units=8))
        net.initialize(ctx=mx.cpu())
        x = np.random.RandomState(0).randn(8, 5).astype(np.float32)
        y = (np.arange(8) % 3).astype(np.float32)
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        st = ShardedTrainer(net, loss, "sgd", {"learning_rate": 0.1,
                            "momentum": 0.9}, shard_optimizer_state=True)
        assert st._mesh == m and len(st._zero) == 6
        comp = ShardedTrainer(net, loss, "sgd", {"learning_rate": 0.1},
                              gradient_compression={"threshold": 0.1})
        for _ in range(2):
            st.step(x, y)
            comp.step(x, y)
        with TrainerCheckpoint(os.path.join(tmp, "ck")) as ck:
            ck.save(2, st, wait=True)
            other = ShardedTrainer(net, loss, "sgd", {"learning_rate": 0.1,
                                   "momentum": 0.9})
            assert ck.restore_latest(other) == 2
        assert all(torch.equal(a, b) for a, b in zip(
            st.params.values(), other.params.values()))
    rec = [json.loads(l) for l in open(os.environ["MXTPU_TELEMETRY"])]
    assert rec[0]["event"] == "ckpt_commit" and rec[0]["step"] == 2
    assert chaos.parse_spec("checkpoint.save:p=0.5,kind=raise") == {
        "checkpoint.save": {"p": 0.5, "kind": "raise"}}
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)
print("BAD", bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
