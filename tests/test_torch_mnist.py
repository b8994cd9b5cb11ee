"""tools/torch_train_mnist.py, the port's copy of
example/image_classification/train_mnist.py (LeNet through
`Module.fit`), on the CPU: it passes its own accuracy assert, and its
first steps match the JAX example's.

The example's synthetic data (its `--benchmark` mode: no MNIST files
under --data-dir) is the same in both, from the same numpy seeds. From
the same initial parameters, the cross-entropy of each of the first
three training batches and the parameters after them agree within 1e-5
(fp32; the same ops and SGD update, only summation order differs).
"""
import importlib.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_symbolic_parity import (  # noqa: E402,F401
    no_persistent_compile_cache, restore_shared_state)

pytestmark = pytest.mark.usefixtures("restore_shared_state")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "torch_train_mnist.py")
EXAMPLE = os.path.join(ROOT, "example", "image_classification",
                       "train_mnist.py")
TOL = 1e-5


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_example_passes_its_assert_on_the_cpu(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    # 10 epochs, as chip_smoke.py's mnist phase runs it: the recipe
    # leaves its plateau at an epoch that varies with the initial weights
    # and the CPU's summation order (6 epochs: 0.88-0.96 over thread
    # counts); the JAX package's own test of the example runs 8
    out = subprocess.run(
        [sys.executable, TOOL, "--cpu", "--epochs", "10", "--data-dir",
         str(tmp_path / "no_mnist_here")], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "using synthetic data" in out.stdout
    assert "MNIST_EXAMPLE_OK" in out.stdout


def _first_steps(mx, example, args, init=None, steps=3):
    np.random.seed(1)
    train_iter, _ = example.get_data(args)
    with mx.name.NameManager():     # the same auto names in both
        sym = example.lenet()
    mod = mx.mod.Module(sym, label_names=["softmax_label"],
                        context=mx.cpu())
    mod.bind(train_iter.provide_data, train_iter.provide_label)
    if init is None:
        mx.random.seed(0)
        mod.init_params(mx.init.Uniform(0.01))
    else:
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in init.items()},
                        aux_params={})
    start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": args.lr,
                                         "momentum": 0.9})
    losses = []
    for _, batch in zip(range(steps), train_iter):
        mod.forward_backward(batch)
        mod.update()
        p = mod.get_outputs()[0].asnumpy()
        lab = batch.label[0].asnumpy().astype(int)
        losses.append(float(-np.log(p[np.arange(len(lab)), lab]).mean()))
    end = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return start, losses, end


def test_first_losses_match_the_jax_example(tmp_path):
    args = types.SimpleNamespace(data_dir=str(tmp_path / "no_mnist_here"),
                                 batch_size=64, lr=0.05)
    jex = _load(EXAMPLE, "jax_train_mnist")
    tex = _load(TOOL, "torch_train_mnist")
    start, jl, jend = _first_steps(jmx, jex, args)
    _, tl, tend = _first_steps(tmx, tex, args, init=start)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert sorted(tend) == sorted(jend)
    for k in jend:
        np.testing.assert_allclose(tend[k], jend[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
