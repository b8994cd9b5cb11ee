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


def _python_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


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
