"""The port's `ShardedTrainer` across processes
(mxnet_tpu_torch/parallel/data_parallel.py over a mesh that spans a
gang, mxnet_tpu_torch/parallel/mesh.py's collectives, global-batch
BatchNorm, ZeRO-1, the compressed step, and `gluon.Trainer`'s fused step
under ``MXTPU_ZERO1=1``) on the CPU: one 4-rank gloo gang for the module
(tests/torch_sharded_worker.py, killed whole if it outlives its
timeout), held against the JAX package's one-process `ShardedTrainer` on
``make_mesh({"dp": 4})`` over 4 of the 8 virtual CPU devices, on the same
global batches and weights.

Tolerances are JAX's own tests' (tests/test_parallel.py): losses rtol
1e-5 and atol 1e-6, and each tensor of the state within 1e-5 of max(1,
its largest magnitude) (gloo and XLA sum the ranks in other orders).
Every rank ends with the same state, bit for bit. What is held:

- JAX's dp cases: convergence (60 steps), equal to one device, step_many
  equal to sequential steps (a BatchNorm net: global-batch statistics),
  ZeRO-1 equal to replicated with each rank holding 1/4 of the sharded
  rows, ``batch_axis=1`` with rank-1 labels with and without compression,
  the compressed step in predict and train mode;
- a BatchNorm ResNet (NHWC, its 1x1 convolutions through
  `conv1x1_bn_nhwc`'s plain path) whose weights and moving statistics
  after 3 steps match JAX's global-batch ones;
- the mesh across the gang and its collectives; distinct Dropout masks
  across ranks; the refusals (tp and sp axes, a CUDA-graph trainer over
  gloo, ZeRO-1 with compression, step_many under compression);
- `gluon.Trainer` over 'dist_sync' with ``MXTPU_ZERO1=1`` (SGD and Adam)
  against the replicated fused step and JAX's one-process Trainer on the
  concatenated batch.
"""
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import jax
from jax._src import compilation_cache
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh as jax_make_mesh
from mxnet_tpu_torch.convert import gluon_params_from_jax
import torch_sharded_worker as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_sharded_worker.py")
NPROC = w.NPROC
GANG_TIMEOUT_S = 240
RTOL, ATOL = 1e-5, 1e-6
TOL_REL = 1e-5


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


def rendezvous_env(rdv_dir):
    """The coordinator address and env of a gang whose rank 0 binds a
    free port itself and publishes it in a file of `rdv_dir` (no port is
    probed and closed before rank 0 binds it, so no concurrent process
    can take it in between)."""
    return "127.0.0.1:0", {"MXTPU_DIST_PORT_FILE":
                           os.path.join(rdv_dir, "coordinator.port")}


def run_gang(mode, nproc, inputs, out, timeout=GANG_TIMEOUT_S, env=None):
    """Start `nproc` ranks of the worker by explicit arguments, each in
    its own session; wait for all within `timeout` seconds, then kill
    every process group still alive. Returns [(returncode, output)]."""
    rdv = tempfile.mkdtemp(prefix="mxtpu_rdv_")
    coord, rdv_env = rendezvous_env(rdv)
    # DMLC_WORKER_ID names each rank to its MXTPU_CHAOS_RANK_<r> spec
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, str(nproc), str(r), "--mode", mode,
         "--inputs", inputs, "--out", out], cwd=ROOT,
        env={**_env(), **rdv_env, **(env or {}), "DMLC_WORKER_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
        for r in range(nproc)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            got, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, got.decode(errors="replace")))
    except subprocess.TimeoutExpired:
        pytest.fail("the gang outlived its %d s" % timeout)
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        shutil.rmtree(rdv, ignore_errors=True)
    return outs


def jax_net(kind, seed):
    """The case's JAX net, initialized from `seed`."""
    np.random.seed(seed)
    jmx.random.seed(seed)
    if kind == "resnet":
        net = w.build_resnet(jresnet)
        net.initialize(jmx.init.Xavier(magnitude=2))
        net.infer_shape(jmx.nd.zeros((1, w.RESNET["img"], w.RESNET["img"],
                                      3)))
        for p in net.collect_params().values():
            p._finish_deferred_init()
        return net
    net = w.build(jgluon, kind)
    net.initialize(jmx.init.Xavier())
    return net


KINDS = sorted({c[0] for c in w.CASES.values()} |
               {"dropout", "fused_mlp", "ckpt"})


def write_inputs(path, extra=None):
    """The JAX nets of every kind, their weights as the worker loads
    them, written to `path`; returns the JAX nets."""
    nets = {k: jax_net(k, 10 + i) for i, k in enumerate(KINDS)}
    inputs = {k: gluon_params_from_jax(
        n, "cpu", "NHWC" if k == "resnet" else "NCHW")
        for k, n in nets.items()}
    inputs.update(extra or {})
    torch.save(inputs, path)
    return nets


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """(JAX nets, {rank: results}) of the module's one 4-rank gang."""
    d = tmp_path_factory.mktemp("sharded_gang")
    inputs = str(d / "inputs.pt")
    nets = write_inputs(inputs)
    outs = run_gang("parity", NPROC, inputs, str(d))
    for r, (rc, log) in enumerate(outs):
        assert rc == 0 and "WORKER_%d_OK" % r in log, log[-6000:]
    return nets, {r: torch.load(str(d / ("rank%d.pt" % r)))
                  for r in range(NPROC)}


def jax_trainer(nets, case, n_dp=NPROC, **over):
    kind, opt, hp, kw, _ = w.CASES[case]
    loss = w.loss_of(jgluon, kind)
    return JaxTrainer(nets[kind], lambda o, l: loss(o, l), opt, dict(hp),
                      mesh=jax_make_mesh({"dp": n_dp},
                                         devices=jax.devices()[:n_dp]),
                      **dict(kw, **over))


def jax_run(nets, case, n_dp=NPROC, **over):
    st = jax_trainer(nets, case, n_dp, **over)
    x, y = w.batch(case)
    losses = [float(np.asarray(st.step(x, y)._data))
              for _ in range(w.CASES[case][4])]
    return st, losses


def flat(state, tag=""):
    """{tag/block path: float64 array in the port's layout} of a state
    dict keyed by block paths (nested for Adam), either package's."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(flat(v, tag + k + "/"))
            continue
        out[tag + k] = v.detach().double().numpy() \
            if isinstance(v, torch.Tensor) else v
    return out


def rel_errs(got, want):
    """{name: max |got - want| / max(1, max |want|)}."""
    a, b = flat(got), flat(want)
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    return {k: float(np.abs(a[k] - v).max()) / max(1.0, float(
        np.abs(v).max())) if v.size else 0.0 for k, v in b.items()}


def paths_of(net):
    """{Gluon name: block path} of a JAX net."""
    return {p.name: k for k, p in net._collect_params_with_prefix().items()}


def renamed(tree, names, nhwc=False):
    """`tree` keyed by block paths, its JAX arrays as float64 numpy in the
    port's layout (an NHWC conv weight (O, kh, kw, I) as (O, I, kh,
    kw))."""
    if isinstance(tree, dict):
        return {names.get(k, k): renamed(v, names, nhwc)
                for k, v in tree.items()}
    arr = np.asarray(jnp.asarray(tree, jnp.float32)).astype(np.float64)
    return arr.transpose(0, 3, 1, 2) if nhwc and arr.ndim == 4 else arr


def jax_state(st, net, opt=True):
    out = {"params": st._params, "aux": st._aux}
    if opt and st._opt_state:
        out["opt_state"] = st._opt_state
    return renamed(out, paths_of(net), nhwc=net.prefix.startswith("resnet"))


def port_state(res, opt=True):
    out = {"params": res["params"], "aux": res["aux"]}
    if opt:
        out["opt_state"] = res["opt_state"]
    return out


def same_bits(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in
                                        zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_every_rank_ends_the_same(gang):
    _, res = gang
    for case in w.CASES:
        for r in range(1, NPROC):
            assert same_bits(port_state(res[r][case]),
                             port_state(res[0][case])), (case, r)
            assert res[r][case]["losses"] == res[0][case]["losses"], case
    for r in range(1, NPROC):
        assert same_bits(res[r]["fused"], res[0]["fused"])


# the dp cases of JAX's tests/test_parallel.py, against JAX at dp=4
@pytest.mark.parametrize("case", ["convergence", "single", "convbn",
                                  "zero1", "zero1_rep", "zero1_sgd",
                                  "batch_axis1", "resnet"])
def test_case_matches_jax_on_a_dp4_mesh(gang, case):
    nets, res = gang
    got = res[0][case]
    jst, want = jax_run(nets, case)
    np.testing.assert_allclose(got["losses"], want, rtol=RTOL, atol=ATOL)
    # JAX keeps no optimizer state for SGD at momentum 0; the port's
    # momenta then hold m' = g
    has_opt = bool(jst._opt_state)
    errs = rel_errs(port_state(got, has_opt),
                    jax_state(jst, nets[w.CASES[case][0]], has_opt))
    assert max(errs.values()) <= TOL_REL, sorted(
        errs.items(), key=lambda kv: -kv[1])[:4]


def test_convergence_and_one_device(gang):
    """JAX :26 (the regression converges over dp) and :46 (dp training
    equals one device)."""
    nets, res = gang
    assert res[0]["convergence"]["losses"][-1] < 1e-2
    _, one = jax_run(nets, "single", n_dp=1)
    assert np.allclose(res[0]["single"]["losses"], one, rtol=1e-5), \
        (res[0]["single"]["losses"], one)


def test_step_many_equals_sequential_steps(gang):
    """JAX :171: step_many(5) over the BatchNorm net equals 5 steps (and
    its count), and JAX's step_many at dp=4."""
    nets, res = gang
    got = res[0]["convbn"]
    np.testing.assert_allclose(got["losses"], got["many"].numpy(),
                               rtol=RTOL, atol=ATOL)
    assert got["many_count"] == 5
    errs = rel_errs(port_state(got["many_state"]), port_state(got))
    assert max(errs.values()) <= TOL_REL
    jst = jax_trainer(nets, "convbn")
    x, y = w.batch("convbn")
    many = np.asarray(jst.step_many(x, y, n_steps=5)._data)
    np.testing.assert_allclose(got["many"].numpy(), many, rtol=RTOL,
                               atol=ATOL)


def test_zero1_equals_replicated_with_the_rows_split(gang):
    """JAX :203: ZeRO-1 has the replicated numerics; each rank holds 1/4
    of the rows of every sharded state (shape[0] divisible by 4: the
    (32, 16) weight and the (32,) bias; the (10, 32) weight and (10,)
    bias stay whole)."""
    nets, res = gang
    z, rep = res[0]["zero1"], res[0]["zero1_rep"]
    np.testing.assert_allclose(z["losses"], rep["losses"], rtol=RTOL,
                               atol=ATOL)
    errs = rel_errs(port_state(z), port_state(rep))
    assert max(errs.values()) <= TOL_REL
    whole = {k: tuple(v.shape) for k, v in z["params"].items()}
    assert sorted(z["zero_keys"]) == sorted(
        k for k, s in whole.items() if s[0] % NPROC == 0)
    assert len(z["zero_keys"]) == 2
    for k, rows in z["local_opt_rows"].items():
        want = (whole[k][0] // NPROC,) + whole[k][1:] \
            if k in z["zero_keys"] else whole[k]
        assert rows == want, (k, rows, want)
    jst, _ = jax_run(nets, "zero1")
    assert jst._shard_opt
    assert res[0]["zero1_sgd"]["zero_keys"] == z["zero_keys"]


@pytest.mark.parametrize("case", ["batch_axis1_comp", "comp_predict",
                                  "comp_train"])
def test_compressed_step_matches_jax(gang, case):
    """The compressed step (JAX :603-720 over shard_map): 2-bit codes with
    error feedback, the words all-gathered, dequantized and summed in rank
    order; BatchNorm on each rank's own statistics, the moving ones
    pmean'd; predict mode writes no statistics. Losses, weights,
    statistics and each rank's residual against JAX's."""
    nets, res = gang
    got = res[0][case]
    jst, want = jax_run(nets, case)
    np.testing.assert_allclose(got["losses"], want, rtol=RTOL, atol=ATOL)
    net = nets[w.CASES[case][0]]
    has_opt = bool(jst._opt_state)
    errs = rel_errs(port_state(got, has_opt), jax_state(jst, net, has_opt))
    assert max(errs.values()) <= TOL_REL, sorted(
        errs.items(), key=lambda kv: -kv[1])[:4]
    banks = renamed(jst._gc_residuals, paths_of(net))
    for r in range(NPROC):
        for k, v in res[r][case]["residual"].items():
            err = np.abs(v.double().numpy() - banks[k][r]).max()
            assert err <= TOL_REL, (r, k, err)
    if case == "comp_predict":      # the initial running statistics
        for k, v in got["aux"].items():
            assert torch.equal(v, torch.zeros_like(v) if "mean" in k
                               else torch.ones_like(v)), k


def test_resnet_batchnorm_uses_the_global_batch(gang):
    """The narrow NHWC ResNet: every 1x1 conv + BatchNorm pair ran
    through `Conv1x1BNStats` (6 a forward, 3 steps, plus the
    backward's none), and its moving statistics follow the global batch
    (they differ from a rank's own: JAX's dp=4 state is matched in
    test_case_matches_jax_on_a_dp4_mesh[resnet])."""
    _, res = gang
    assert res[0]["resnet"]["conv1x1_bn_calls"] == 6 * w.RESNET["steps"]
    aux = res[0]["resnet"]["aux"]
    assert aux and all(torch.isfinite(v).all() for v in aux.values())


def test_mesh_across_the_gang(gang):
    _, res = gang
    for r in range(NPROC):
        m = res[r]["mesh"]
        assert m["shape"] == {"dp": 2, "tp": 2}
        assert m["dp_shape"] == {"dp": NPROC}
        assert m["index"] == (r // 2, r % 2)
        assert m["device"] == "cpu"
        whole = torch.arange(24, dtype=torch.float32).reshape(8, 3)
        assert torch.equal(m["put_dp"], whole[4 * (r // 2):4 * (r // 2) + 4])
        assert torch.equal(m["put_both"], whole[2 * r:2 * r + 2])
        total = sum(range(1, NPROC + 1))
        assert torch.equal(m["psum"], torch.full((3,), float(total)))
        assert torch.allclose(m["pmean"], torch.full((3,), total / NPROC))
        assert torch.equal(m["all_gather"], torch.stack(
            [torch.full((3,), float(i + 1)) for i in range(NPROC)]))
        assert torch.equal(m["all_gather_tiled"],
                           m["all_gather"].reshape(-1))
        # tp pairs ranks (0, 1) and (2, 3)
        pair = 2 * (r // 2)
        assert torch.equal(m["tp_psum"], torch.full((3,), float(
            (pair + 1) + (pair + 2))))
        # d/da of sum(pmean(a) * (r + 1)), summed over ranks: pmean of
        # the incoming (r + 1)
        assert torch.allclose(m["pmean_grad"],
                              torch.full((2,), total / NPROC))
        assert torch.equal(m["smap_sum"],
                           torch.full((2,), float(whole.sum())))
        assert torch.equal(m["smap_local"],
                           whole[2 * r:2 * r + 2] * r)


def test_dropout_masks_differ_across_ranks(gang):
    """Each rank draws its own stream (JAX folds axis_index into the key):
    the 4 ranks' masks differ, and differ from step to step."""
    _, res = gang
    masks = [res[r]["dropout"]["masks"] for r in range(NPROC)]
    assert masks[0].shape[0] == w.DROPOUT_STEPS
    for r in range(1, NPROC):
        assert not torch.equal(masks[r], masks[0]), r
        assert res[r]["dropout"]["losses"] == res[0]["dropout"]["losses"]
    assert not torch.equal(masks[0][0], masks[0][1])
    assert all(0 < m.float().mean() < 1 for m in masks)


def test_refusals(gang):
    _, res = gang
    out = res[0]["refusals"]
    assert "A6d" in out["tp"] and "'tp'" in out["tp"]
    assert "A6d" in out["sp"] and "'sp'" in out["sp"]
    assert "gradient_compression" in out["zero1_compression"]
    assert "MXTPU_CUDA_GRAPH=0" in out["graph_over_gloo"]
    assert "step_many" in out["step_many_compressed"]


def test_fused_step_zero1_matches_replicated_and_jax(gang):
    """gluon.Trainer over 'dist_sync' with MXTPU_ZERO1=1: the state is
    carried in blocks (one per update group), the gauge counts the
    sharded parameters; after 3 fused steps and one staged step (which
    first gathers the blocks into the per-key states), weights and the
    whole states (after get_states' all-gather) equal the replicated
    fused step's and JAX's one-process Trainer on the concatenated batch
    (within 1e-6 of each tensor's largest magnitude, as
    tests/test_torch_kvstore_dist.py holds the replicated one)."""
    nets, res = gang
    got = res[0]["fused"]
    n_params = len(got["sgd_zero1"])
    for opt, hp in (("sgd", w.SGD), ("adam", {"learning_rate": 0.01,
                                              "wd": 1e-4})):
        z, rep = got[opt + "_zero1"], got[opt + "_zero0"]
        assert got[opt + "_zero1_gauge"] == n_params
        assert got[opt + "_zero1_carried"] >= 1
        assert got[opt + "_zero0_carried"] == 0
        for i in range(n_params):
            assert torch.allclose(z[i], rep[i], rtol=0, atol=1e-6 * max(
                1.0, float(rep[i].abs().max())))
        for a, b in zip(got[opt + "_zero1_state"],
                        got[opt + "_zero0_state"]):
            assert torch.allclose(a, b, rtol=0, atol=1e-6 * max(
                1.0, float(b.abs().max())))
        jnet = jax_net("fused_mlp", 10 + KINDS.index("fused_mlp"))
        tr = jgluon.Trainer(jnet.collect_params(), opt, dict(hp))
        loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
        for s in range(w.FUSED_STEPS + 1):
            xs, ys = zip(*[w.fused_batch(s, r) for r in range(NPROC)])
            with jmx.autograd.record():
                loss = loss_fn(jnet(jmx.nd.array(np.concatenate(xs))),
                               jmx.nd.array(np.concatenate(ys)))
            loss.backward()
            tr.step(w.FUSED["batch"] * NPROC)
        for i, p in enumerate(jnet.collect_params().values()):
            want = np.asarray(p.data()._data)
            err = np.abs(z[i].numpy() - want).max() / max(
                1.0, np.abs(want).max())
            assert err <= 1e-6, (opt, p.name, err)
