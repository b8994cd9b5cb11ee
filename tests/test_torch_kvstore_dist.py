"""The port's distributed KVStore (mxnet_tpu_torch/parallel/kvstore_dist.py)
across processes, on the CPU: one 4-rank gloo gang per module, launched
as a user launches one (``tools/launch.py -n 4 python
tests/torch_dist_worker.py``), killed whole if it outlives its timeout.

The worker asserts the store's exact sums and its API in every rank
(dense fp32 over rounds, fp16, a key larger than a bucket, repeated keys,
the updater path, bucketed against per-key bit for bit with one
collective per bucket, 2-bit compression on the wire). Here:

- every rank ends with the same weights, bit for bit: an MLP through
  `gluon.Trainer` fused and staged, and with 2-bit compression; a NHWC
  ResNet V1 with BatchNorm (its running statistics are each rank's own);
  `Module.fit(kvstore="dist_sync")`;
- fused equals staged bit for bit, with the fused step's launches
  counted (one collective per flat, one launch per update group);
- the MLP equals the JAX package's one-process `gluon.Trainer` on the
  concatenated batch within 1e-6 of each tensor's largest magnitude;
- the ResNet equals a one-process port oracle that sums the 4 ranks'
  gradients in rank order, within 1e-5 (of max(1, |w|): gloo's ring adds
  in another order);
- with compression the ranks equal the exact oracle bit for bit;
- a rank started by explicit arguments joins a gang too (2 ranks);
  'dist_async' raises.
"""
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import jax
from jax._src import compilation_cache
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
import torch_dist_worker as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
NPROC = 4
GANG_TIMEOUT_S = 120


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


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_COORDINATOR", "JAX_NUM_PROCESSES",
                                "JAX_PROCESS_ID", "DMLC_", "MXTPU_"))}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_gang(argvs, timeout):
    """Start each argv in its own session; wait for all within `timeout`
    seconds, then kill every process group still alive. Returns
    [(returncode, output)]."""
    procs = [subprocess.Popen(a, cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              start_new_session=True) for a in argvs]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out.decode(errors="replace")))
    except subprocess.TimeoutExpired:
        pytest.fail("the gang outlived its %d s" % timeout)
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    return outs


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """{rank: arrays} of the 4-rank gang run through tools/launch.py."""
    out = str(tmp_path_factory.mktemp("gang"))
    [(rc, log)] = _run_gang([[
        sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
        str(NPROC), sys.executable, WORKER, "--out", out]], GANG_TIMEOUT_S)
    assert rc == 0, log[-4000:]
    for r in range(NPROC):
        assert "WORKER_%d_OK" % r in log and "STORE_OK_%d" % r in log, \
            log[-4000:]
    return {r: dict(np.load(os.path.join(out, "rank%d.npz" % r)))
            for r in range(NPROC)}


def _keys(arrays, tag):
    return sorted((k for k in arrays if k.startswith(tag + "_")),
                  key=lambda k: (len(k), k))


def _one_thread(fn):
    """`fn()` with torch on one thread, as the worker ran."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(was)


@pytest.mark.parametrize("tag", ["mlp_fused", "mlp_staged", "mlp_comp",
                                 "resnet_fused", "resnet_staged", "module"])
def test_every_rank_ends_with_the_same_weights(gang, tag):
    keys = _keys(gang[0], tag)
    assert keys
    own = _running_keys(tag) if "resnet" in tag else set()
    for k in keys:
        if k in own:
            continue
        for r in range(1, NPROC):
            assert gang[r][k].tobytes() == gang[0][k].tobytes(), (k, r)


def _running_keys(tag):
    """The ResNet's running statistics: each rank's own."""
    names = list(_one_thread(
        lambda: w.build_resnet(torch.device("cpu"))).collect_params())
    return {"%s_%d" % (tag, i) for i, n in enumerate(names)
            if "_running_" in n}


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_fused_equals_staged(gang, kind):
    for r in range(NPROC):
        for k in _keys(gang[r], kind + "_fused"):
            staged = k.replace("_fused_", "_staged_")
            assert gang[r][k].tobytes() == gang[r][staged].tobytes(), (r, k)


def test_fused_step_launches_are_counted(gang):
    """train.step.dispatches over the fused MLP steps: one collective per
    flat and one launch per update group, a step."""
    dispatches, flats, groups, steps = gang[0]["counts"].tolist()
    assert flats == 1 and groups == steps == w.STEPS
    assert dispatches == steps * flats + groups


def test_mlp_matches_the_jax_trainer_on_the_concatenated_batch(gang):
    jnet = jgluon.nn.HybridSequential()
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(w.MLP["hidden"], activation="relu",
                                 in_units=w.MLP["in_units"]),
                 jgluon.nn.Dense(w.MLP["classes"],
                                 in_units=w.MLP["hidden"]))
    jnet.initialize()
    for p, a in zip(jnet.collect_params().values(), w.mlp_weights()):
        p.set_data(jmx.nd.array(a.astype(np.float32)))
    tr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(w.OPT))
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    for s in range(w.STEPS):
        xs, ys = zip(*[w.mlp_batch(s, r) for r in range(NPROC)])
        tr.set_learning_rate(w.LRS[s])
        with jmx.autograd.record():
            loss = loss_fn(jnet(jmx.nd.array(np.concatenate(xs))),
                           jmx.nd.array(np.concatenate(ys)))
        loss.backward()
        tr.step(w.MLP["batch"] * NPROC)
    for k, p in zip(_keys(gang[0], "mlp_fused"),
                    jnet.collect_params().values()):
        want = np.asarray(p.data()._data)
        err = np.abs(gang[0][k] - want).max() / np.abs(want).max()
        assert err <= 1e-6, (p.name, err)


def test_resnet_matches_the_one_process_oracle(gang):
    oracle = _one_thread(lambda: w.resnet_oracle(
        mx, torch.device("cpu"), NPROC, batch=2))
    for r in range(NPROC):
        for k, ok in zip(_keys(gang[r], "resnet_fused"),
                         _keys(oracle[r], "resnet")):
            got, want = gang[r][k], oracle[r][ok]
            err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
            assert err <= 1e-5, (r, k, err)


def test_compressed_ranks_equal_the_exact_oracle(gang):
    oracle = _one_thread(lambda: w.compressed_mlp_oracle(
        mx, torch.device("cpu"), NPROC))
    moved = False
    for k, a in zip(_keys(gang[0], "mlp_comp"), w.mlp_weights()):
        assert gang[0][k].tobytes() == oracle[k].tobytes(), k
        moved |= not np.array_equal(gang[0][k], a.astype(np.float32))
    assert moved
    # the compressed run is not the exact one
    assert any(gang[0][k].tobytes() != gang[0][k.replace("comp", "staged")]
               .tobytes() for k in _keys(gang[0], "mlp_comp"))


def test_a_rank_started_by_explicit_arguments_joins(tmp_path):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coordinator = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    outs = _run_gang([[sys.executable, WORKER, coordinator, "2", str(r),
                       "--out", str(tmp_path)] for r in range(2)],
                     GANG_TIMEOUT_S)
    for r, (rc, log) in enumerate(outs):
        assert rc == 0 and "WORKER_%d_OK" % r in log, log[-4000:]
    a, b = (np.load(str(tmp_path / ("rank%d.npz" % r))) for r in range(2))
    assert all(a[k].tobytes() == b[k].tobytes() for k in _keys(a, "mlp_fused"))


def test_dist_async_raises():
    with pytest.raises(MXNetError, match="dist_async"):
        mx.kv.create("dist_async")


class _Store:
    def __init__(self, type, num_workers):
        self.type, self.num_workers = type, num_workers


def _bound(pkg):
    data = pkg.sym.var("data")
    net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        data, num_hidden=4, name="fc"), name="softmax")
    kw = {"context": pkg.cpu()}
    mod = pkg.mod.Module(net, data_names=("data",),
                         label_names=("softmax_label",), **kw)
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    return mod


@pytest.mark.parametrize("kv_type,scale", [("dist_sync", 32),
                                           ("dist_device_sync", 32),
                                           ("tpu_dist", 8), ("dist", 8),
                                           ("device", 8)])
def test_rescale_keeps_jaxs_rule_for_tpu_dist(kv_type, scale):
    """Module's rescale_grad over 4 workers at batch 8: the worker count
    folds in only for types holding "dist" and "_sync", in both packages
    (ROADMAP C: `tpu_dist` and `dist` keep the local batch)."""
    store = _Store(kv_type, NPROC)
    with mx.cpu():
        port = _bound(mx)._effective_rescale(store)
    assert port == _bound(jmx)._effective_rescale(store) == 1.0 / scale
