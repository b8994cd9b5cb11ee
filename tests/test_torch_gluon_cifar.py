"""The CIFAR-10 example (example/gluon/train_cifar10.py) through the port,
on the CPU.

`tools/torch_train_cifar10.py` is the example with its imports swapped
for the port's: run as published (resnet18_v1, SGD lr 0.1 momentum 0.9
wd 1e-4, batch 128, 2 epochs over the 2048 synthetic images), it must
pass its own assert (accuracy above 0.25 and no lower than epoch 0's).
Then the example's loop at its batch of 128, 3 steps on its first 3
batches without shuffling, from the same seeded Xavier weights carried
over by block path, against the JAX package's (hybridized). Step 1 runs
from equal weights: its loss agrees within 1e-4 and the output layer's
weight and bias after it within 1e-5 of their largest magnitude (fp32;
the gradient reaches that layer through no ReLU or max-pool). Below the
output layer the gradient is not continuous: an fp32 rounding puts a
ReLU input or a max-pool's runner-up on the other side, which moves a
whole gradient element, so the JAX package's own eager step departs
from its hybridized one by about 1 % of the first convolution's update.
And the loop is chaotic at lr 0.1 from Xavier weights (the first update
is as large as the first convolution's weights), so that noise grows
step by step. The JAX package's eager-against-hybridized departure is
then the yardstick: the port's losses and weights stay within NOISE
times it (plus 1e-4) of the hybridized JAX loop's, after step 1 and
after step 3."""
import os
import subprocess
import sys

import numpy as np
import jax
from jax._src import compilation_cache
import pytest

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.convert import gluon_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-4
OUTPUT_TOL = 1e-5
NOISE = 2.0


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_compile_cache():
    """The session's persistent compile cache (tests/conftest.py) installs
    a read guard that takes one argument fewer than jax 0.9 passes it, so
    every JAX compile under it raises. This module's JAX compiles run with
    the cache off; the setting is restored, and the cache reset, after."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


def test_port_example_trains_two_epochs_and_passes_its_assert(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="4")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_train_cifar10.py"),
         "--cpu", "--data-dir", str(tmp_path / "absent")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert "synthetic data" in lines[0] and lines[-1] == "CIFAR_EXAMPLE_OK"
    accs = [float(line.split()[-1]) for line in lines
            if line.startswith("epoch")]
    assert len(accs) == 2 and accs[1] > 0.25 and accs[1] >= accs[0]


def _synthetic(n):
    """The example's learnable stand-in for CIFAR-10 (its first n
    images): class = (spatial pattern, colour channel)."""
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, 2048)[:n]
    x = np.zeros((n, 3, 32, 32), "float32")
    xs = np.arange(32)
    for i in range(n):
        c = y[i]
        ang = (c % 5) * np.pi / 5
        g = np.cos(ang) * xs[None, :] + np.sin(ang) * xs[:, None]
        x[i, c // 5] = (np.sin(2 * np.pi * g / 6) > 0).astype("float32")
        x[i] += rng.randn(3, 32, 32) * 0.15
    return x, y.astype("float32")


def _loop(pkg, net, x, y, batch):
    """The example's loop over the first batches, in order. Returns the
    losses and the weights after each step."""
    g = pkg.gluon
    loader = g.data.DataLoader(g.data.ArrayDataset(x, y), batch_size=batch,
                               shuffle=False, last_batch="discard")
    trainer = g.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    loss_fn = g.loss.SoftmaxCrossEntropyLoss()
    losses, weights = [], []
    for xb, yb in loader:
        with pkg.autograd.record():
            out = net(xb)
            loss = loss_fn(out, yb)
        loss.backward()
        trainer.step(xb.shape[0])
        losses.append(float(loss.mean().asscalar()))
        weights.append(_weights(net, pkg is tmx))
    return np.array(losses), weights


def _jax_net(x, hybridize):
    mx.random.seed(1)
    net = jgluon.model_zoo.vision.get_model("resnet18_v1", classes=10)
    net.initialize(mx.initializer.Xavier())
    if hybridize:
        net.hybridize()
    net(mx.nd.array(x[:1]))             # the deferred shapes resolve
    return net


def _weights(net, port):
    return {k: (p.data().detach().numpy().copy() if port else
                p.data().asnumpy())
            for k, p in net._collect_params_with_prefix().items()}


def test_three_steps_match_the_jax_loop():
    batch = 128
    x, y = _synthetic(3 * batch)
    jnet, eager = _jax_net(x, True), _jax_net(x, False)
    with tmx.cpu():
        tnet = gluon.model_zoo.vision.get_model("resnet18_v1", classes=10)
        tnet.load_parameters(gluon_params_from_jax(jnet, "cpu"))
        got, tw = _loop(tmx, tnet, x, y, batch)
    want, jw = _loop(mx, jnet, x, y, batch)
    eager_losses, ew = _loop(mx, eager, x, y, batch)
    noise = np.abs(eager_losses - want)
    assert len(got) == len(want) == 3
    assert abs(got[0] - want[0]) < LOSS_TOL, (got, want)
    for k in ("output.weight", "output.bias"):
        err = np.abs(tw[0][k] - jw[0][k]).max() / np.abs(jw[0][k]).max()
        assert err < OUTPUT_TOL, (k, err)
    assert (np.abs(got - want) <= NOISE * noise + LOSS_TOL).all(), \
        (got, want, noise)
    for step in (0, 2):
        w_noise = max(np.abs(ew[step][k] - jw[step][k]).max()
                      for k in jw[step])
        w_err = max(np.abs(tw[step][k] - jw[step][k]).max()
                    for k in jw[step])
        assert w_err <= NOISE * w_noise + LOSS_TOL, (step, w_err, w_noise)
