"""The port's distributed KVStore (mxnet_tpu_torch/parallel/kvstore_dist.py)
across processes, on the CPU: one 4-rank gloo gang per module, launched
as a user launches one (``tools/torch_launch.py -n 4 python
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
  'dist_async' is the synchronous store under that name, as in JAX;
- the timeouts are JAX's (two 2-rank gangs): ``MXTPU_DIST_INIT_TIMEOUT_S``
  bounds the rendezvous alone, so a barrier waits for a peer that comes
  later than it; ``MXTPU_BARRIER_TIMEOUT_S`` bounds the barrier, which
  raises `DeadlineExceeded` when a peer never comes.
"""
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import jax
from jax._src import compilation_cache
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as mx
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


def _run_gang(argvs, timeout, env=None):
    """Start each argv in its own session (with `env` added to the
    environment); wait for all within `timeout` seconds, then kill every
    process group still alive. Returns [(returncode, output)]."""
    procs = [subprocess.Popen(a, cwd=ROOT, env={**_env(), **(env or {})},
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
    """{rank: arrays} of the 4-rank gang run through tools/torch_launch.py
    (rank 0 binds the coordinator's port and publishes it)."""
    out = str(tmp_path_factory.mktemp("gang"))
    [(rc, log)] = _run_gang([[
        sys.executable, os.path.join(ROOT, "tools", "torch_launch.py"), "-n",
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


def _rendezvous(tmp_path):
    """Port 0: rank 0 binds a free port and publishes it in a file the
    other rank waits for, so no port is probed and closed before rank 0
    binds it."""
    return "127.0.0.1:0", {"MXTPU_DIST_PORT_FILE":
                           str(tmp_path / "coordinator.port")}


def test_a_rank_started_by_explicit_arguments_joins(tmp_path):
    coordinator, env = _rendezvous(tmp_path)
    outs = _run_gang([[sys.executable, WORKER, coordinator, "2", str(r),
                       "--out", str(tmp_path)] for r in range(2)],
                     GANG_TIMEOUT_S, env)
    for r, (rc, log) in enumerate(outs):
        assert rc == 0 and "WORKER_%d_OK" % r in log, log[-4000:]
    a, b = (np.load(str(tmp_path / ("rank%d.npz" % r))) for r in range(2))
    assert all(a[k].tobytes() == b[k].tobytes() for k in _keys(a, "mlp_fused"))


def test_dist_async_raises():
    """'dist_async' no longer raises: as in the JAX package
    (kvstore.py:453-456), it is the synchronous distributed store under
    that name, here at one process on the CPU."""
    from mxnet_tpu_torch.parallel.kvstore_dist import DistKVStore
    with mx.cpu():
        kv = mx.kv.create("dist_async")
    assert isinstance(kv, DistKVStore) and kv.type == "dist_async"
    assert kv.num_workers == 1 and kv.device == torch.device("cpu")
    kv.init(3, torch.ones(2))
    kv.push(3, torch.full((2,), 2.0))
    out = torch.zeros(2)
    kv.pull(3, out=out)
    assert out.tolist() == [2.0, 2.0]
    kv.barrier()


BARRIER_GANG_S = 60
# one rank of a 2-rank gloo gang on the CPU: argv COORDINATOR RANK MODE
# FLAG. "late": rank 1 reaches the barrier 8 s after rank 0. "never": rank
# 1 never reaches it; it waits for rank 0's FLAG file, then leaves.
BARRIER_WORKER = r"""
import os, sys, time
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.parallel.kvstore_dist import init_distributed
from mxnet_tpu_torch.resilience.retry import DeadlineExceeded
coordinator, rank, mode, flag = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
with mx.cpu():
    init_distributed(coordinator, 2, rank)
    kv = mx.kv.create("dist_sync")
    if mode == "late":
        if rank == 1:
            time.sleep(8)
        t0 = time.monotonic()
        kv.barrier()
        print("BARRIER_OK_%d %.3f" % (rank, time.monotonic() - t0),
              flush=True)
    elif rank == 0:
        t0 = time.monotonic()
        try:
            kv.barrier()
            print("BARRIER_RETURNED", flush=True)
        except DeadlineExceeded as err:
            print("DEADLINE_%.3f %s" % (time.monotonic() - t0, err),
                  flush=True)
        open(flag, "w").close()
    else:
        t0 = time.monotonic()
        while not os.path.exists(flag) and time.monotonic() - t0 < 40:
            time.sleep(0.1)
        print("PEER_LEFT", flush=True)
# the never-met barrier is still pending in gloo: leave without teardown
os._exit(0)
"""


def _barrier_gang(tmp_path, mode, env):
    coordinator, rdv_env = _rendezvous(tmp_path)
    flag = str(tmp_path / "rank0_done")
    return _run_gang([[sys.executable, "-c", BARRIER_WORKER, coordinator,
                       str(r), mode, flag] for r in range(2)],
                     BARRIER_GANG_S, {**rdv_env, **env})


# one rank of a 2-rank gloo gang that only meets its peer: argv RANK
RENDEZVOUS_WORKER = r"""
import os, sys
import torch
import torch.distributed as dist
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.parallel.kvstore_dist import init_distributed
rank = int(sys.argv[1])
with mx.cpu():
    init_distributed("127.0.0.1:0", 2, rank)
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    print("RDV_OK_%d %g" % (rank, t.item()), flush=True)
    dist.destroy_process_group()
"""


def test_concurrent_gangs_rendezvous_on_ports_their_rank_0_bound(tmp_path):
    """Three 2-rank gangs start at once, as the suite's parallel workers
    start theirs: every rank 0 binds port 0 and publishes the port it got,
    so no port is probed and closed first for another process to take in
    between. All six ranks meet their peer, each gang on its own port."""
    gangs = []
    for g in range(3):
        coordinator, env = _rendezvous(tmp_path / ("g%d" % g))
        os.makedirs(str(tmp_path / ("g%d" % g)))
        gangs.append((env, [[sys.executable, "-c", RENDEZVOUS_WORKER,
                             str(r)] for r in range(2)]))
    results = [None] * 3

    def run(g):
        env, argvs = gangs[g]
        results[g] = _run_gang(argvs, BARRIER_GANG_S, env)
    threads = [threading.Thread(target=run, args=(g,)) for g in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ports = set()
    for g, outs in enumerate(results):
        for r, (rc, log) in enumerate(outs):
            assert rc == 0 and "RDV_OK_%d 3" % r in log, log[-4000:]
        with open(gangs[g][0]["MXTPU_DIST_PORT_FILE"]) as f:
            ports.add(int(f.read()))
    assert len(ports) == 3 and 0 not in ports


def test_init_timeout_bounds_the_rendezvous_alone(tmp_path):
    """With a 3 s init knob, rank 1 reaches the barrier 8 s after rank 0:
    the knob bounds only the rendezvous (JAX's ``initialization_timeout``,
    mxnet_tpu/parallel/kvstore_dist.py:133-135), so rank 0's barrier waits
    for it and both pass."""
    outs = _barrier_gang(tmp_path, "late",
                         {"MXTPU_DIST_INIT_TIMEOUT_S": "3"})
    for r, (rc, log) in enumerate(outs):
        assert rc == 0 and "BARRIER_OK_%d" % r in log, log[-4000:]
    waited = float(outs[0][1].split("BARRIER_OK_0 ")[1].split()[0])
    assert waited > 3.0, outs[0][1][-4000:]


def test_barrier_raises_deadline_exceeded_when_a_peer_never_comes(tmp_path):
    """With a 2 s barrier knob and a peer that never reaches the barrier,
    `barrier()` raises `DeadlineExceeded` naming the barrier and its
    budget, as JAX's does (its :570-588), after about that long."""
    outs = _barrier_gang(tmp_path, "never",
                         {"MXTPU_BARRIER_TIMEOUT_S": "2"})
    (rc0, log0), (rc1, log1) = outs
    assert rc0 == 0 and "DEADLINE_" in log0, log0[-4000:]
    assert "kvstore barrier across 2 processes" in log0, log0[-4000:]
    waited = float(log0.split("DEADLINE_")[1].split()[0])
    assert 2.0 <= waited < 10.0, log0[-4000:]
    assert rc1 == 0 and "PEER_LEFT" in log1, log1[-4000:]


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
