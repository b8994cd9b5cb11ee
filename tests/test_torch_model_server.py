"""The port's `ModelServer` of both kinds against the JAX package's, on
the CPU (`mxnet_tpu_torch.serving.server`).

The forward kind serves a small MLP symbol frozen from the same weights
in both packages: responses under concurrent clients equal the JAX
engine's direct `infer` within 1e-5 (the same dense op; summation order
may differ) and the port engine's own `infer` at the request's exact
bucket bit for bit. The decode kind serves a narrow GPT whose weights
the JAX block drew (carried by `convert.gpt_params_from_jax`): its fp32
greedy tokens equal the JAX `ModelServer` over a JAX `DecodeEngine`,
called directly in this process, exactly.

Isolation: SIGTERM is raised only in a child process
(tests/torch_serving_drain_worker.py); every server is drained by a
fixture finalizer; every test's lease path is under its `tmp_path`; and
the module asserts that no serving thread it started outlives it and
that the port's lease code never touched the per-uid default lease file
(CPU servers take no lease; the forced-lease test holds one under
`tmp_path`).
"""
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import jax
from jax._src import compilation_cache
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo.gpt import GPTDecoder as JaxGPT
from mxnet_tpu.serving import DecodeEngine as JaxDecodeEngine
from mxnet_tpu.serving import InferenceEngine as JaxEngine
from mxnet_tpu.serving import ModelServer as JaxServer
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import gpt_params_from_jax
from mxnet_tpu_torch.gluon.model_zoo import GPTDecoder
from mxnet_tpu_torch.observability import memory
from mxnet_tpu_torch.observability import registry as obs
from mxnet_tpu_torch.resilience import Deadline, DeadlineExceeded, chaos
from mxnet_tpu_torch.resilience import lease as tlease
from mxnet_tpu_torch.serving import (DecodeEngine, InferenceEngine,
                                     ModelServer, NoHealthyReplica,
                                     RequestRejected, ServerClosed)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
FEATURES, CLASSES = 6, 3
VOCAB = 64
GPT_CFG = dict(max_seq_len=32, num_layers=2, num_heads=2, embed_dim=16)
SERVER_THREADS = ("serving-worker", "serving-dispatch", "serving-canary",
                  "decode-sched", "decode-signal-watch", "lease-heartbeat")
DEFAULT_LEASE = os.path.join(tempfile.gettempdir(),
                             "mxtpu_device_%d.lease" % os.getuid())


@pytest.fixture(scope="module", autouse=True)
def _isolation():
    """JAX compiles run with the session's persistent compile cache off
    (its read guard breaks under jax 0.9), restored after. The module
    leaves no serving thread behind, and the port's lease code never
    creates, writes or reads the per-uid default lease file (every file
    it touches is recorded; other processes may use that file meanwhile,
    so its state alone proves nothing)."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    before = {t.ident for t in threading.enumerate()}
    touched = []

    def spy(fn):
        def wrapped(path, *a, **k):
            touched.append(os.path.abspath(os.fspath(path)))
            return fn(path, *a, **k)
        return wrapped
    with pytest.MonkeyPatch.context() as mp:
        for name in ("exclusive_create", "atomic_write", "read_lease"):
            mp.setattr(tlease, name, spy(getattr(tlease, name)))
        yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()
    deadline = time.monotonic() + 10
    while True:
        left = [t.name for t in threading.enumerate()
                if t.ident not in before and t.is_alive()
                and t.name.startswith(SERVER_THREADS)]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, "serving threads outlived the module: %s" % left
    assert touched and os.path.abspath(DEFAULT_LEASE) not in touched


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    # a watchdog trip's diagnostics read the lease: this test's own
    monkeypatch.setenv("MXTPU_LEASE_PATH", str(tmp_path / "dev.lease"))
    chaos.configure("")
    for k in ("MXTPU_SERVE_DISPATCH_TIMEOUT_S", "MXTPU_LEASE",
              "MXTPU_TELEMETRY", "MXTPU_AOT_STORE"):
        monkeypatch.delenv(k, raising=False)
    yield
    chaos.reset()


@pytest.fixture
def servers():
    """Servers a test starts; each is drained (and its canary joined)
    when the test ends, whatever happened."""
    started = []
    yield started
    chaos.reset()
    for s in started:
        s.drain(timeout=30)
        th = getattr(s, "_canary_thread", None)
        if th is not None:
            th.join(timeout=15)


def _mlp(mx, seed=0):
    rng = np.random.RandomState(seed)
    with mx.name.NameManager():
        h = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=CLASSES,
                                  name="fc1")
        sym = mx.sym.SoftmaxOutput(h, name="softmax")
    args = {"fc1_weight": (rng.randn(CLASSES, FEATURES) * 0.5)
            .astype(np.float32),
            "fc1_bias": rng.randn(CLASSES).astype(np.float32)}
    return sym, args


def _engine(name="mlp", seed=0, max_batch=8):
    sym, args = _mlp(tmx, seed)
    return InferenceEngine.from_symbol(sym, args, {}, {"data": (FEATURES,)},
                                       max_batch, name=name, device="cpu")


def _jax_engine(name="mlp", seed=0, max_batch=8):
    sym, args = _mlp(jmx, seed)
    return JaxEngine.from_symbol(
        sym, {k: jmx.nd.array(v) for k, v in args.items()}, {},
        {"data": (FEATURES,)}, max_batch, name=name)


def _x(n=1, seed=7):
    return np.random.RandomState(seed).randn(n, FEATURES).astype(np.float32)


def _total(name):
    m = obs.REGISTRY.get(name)
    return 0.0 if m is None else float(m.total())


# -- the forward kind -------------------------------------------------------
def test_concurrent_clients_get_jaxs_answers(servers):
    eng = _engine("par")
    jeng = _jax_engine("par")
    srv = ModelServer(eng, max_wait_ms=2.0, warmup=True).start()
    servers.append(srv)
    sizes = [1, 2, 4, 8, 3, 1, 2, 5] * 2
    xs = [_x(n, seed=i) for i, n in enumerate(sizes)]
    outs = [None] * len(xs)

    def client(i):
        outs[i] = srv.infer(xs[i], timeout=30)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for x, out in zip(xs, outs):
        np.testing.assert_allclose(out[0], jeng.infer(x)[0].asnumpy(),
                                   rtol=TOL, atol=TOL)
    # one request a batch at its exact bucket: bit for bit the engine's
    for n in (1, 2, 4, 8):
        x = _x(n, seed=40 + n)
        np.testing.assert_array_equal(srv.infer(x, timeout=30)[0],
                                      eng.infer(x)[0].asnumpy())
    st = srv.stats()
    assert st["served"] == len(xs) + 4 and st["lease"] is None
    assert st["compiled_buckets"] == [1, 2, 4, 8]


def test_mixed_sizes_after_warmup_build_nothing(servers):
    eng = _engine("bounded")
    srv = ModelServer(eng, max_wait_ms=1.0, warmup=True).start()
    servers.append(srv)
    builds = obs.REGISTRY.get("serving.engine.compiles")
    before = sum(builds.get(engine="bounded", bucket=str(b))
                 for b in eng.buckets)
    handles = [srv.submit(_x(n, seed=n)) for n in (1, 7, 3, 8, 2, 5, 6, 4)]
    for h in handles:
        h.result(timeout=30)
    assert before == len(eng.buckets) == sum(
        builds.get(engine="bounded", bucket=str(b)) for b in eng.buckets)


def test_expired_deadline_is_refused_without_compute(servers):
    srv = ModelServer(_engine("dl"), max_wait_ms=1.0, warmup=True).start()
    servers.append(srv)
    with pytest.raises(DeadlineExceeded):
        srv.infer(_x(), deadline=Deadline(0.0), timeout=10)
    assert srv.infer(_x(), timeout=10)[0].shape == (1, CLASSES)


def test_chaos_fault_reaches_the_request_and_the_server_survives(servers):
    srv = ModelServer(_engine("flt"), max_wait_ms=1.0, warmup=True).start()
    servers.append(srv)
    chaos.configure("serving.infer:p=1,kind=fatal,n=1")
    with pytest.raises(chaos.InjectedFailure):
        srv.infer(_x(), timeout=10)
    assert srv.infer(_x(), timeout=10)[0].shape == (1, CLASSES)


def test_overload_sheds_with_the_reject_policy(servers):
    eng = _engine("shed", max_batch=1)
    infer = eng.infer
    eng.infer = lambda *a, **k: (time.sleep(0.05), infer(*a, **k))[1]
    srv = ModelServer(eng, max_batch_size=1, max_wait_ms=0.5,
                      queue_depth=2, warmup=True).start()
    servers.append(srv)
    handles, refused = [], 0
    for i in range(20):
        try:
            handles.append(srv.submit(_x(seed=i)))
        except RequestRejected:
            refused += 1
    for h in handles:
        h.result(timeout=30)
    assert refused > 0 and srv.stats()["shed"] == refused


def test_wedged_replica_quarantined_rerouted_then_readmitted(
        servers, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_DISPATCH_TIMEOUT_S", "0.2")
    monkeypatch.setenv("MXTPU_SERVE_TRIP_LIMIT", "2")
    monkeypatch.setenv("MXTPU_SERVE_CANARY_S", "0.05")
    srv = ModelServer(_engine("wedge"), num_workers=2, max_wait_ms=1.0,
                      warmup=True).start()
    servers.append(srv)
    chaos.configure("serving.replica0.dispatch:kind=hang,secs=2,n=3")
    for i in range(6):
        assert srv.infer(_x(seed=i), timeout=30)[0].shape == (1, CLASSES)
    states = []
    stop = time.monotonic() + 30
    while time.monotonic() < stop:
        st = {w["index"]: w["state"] for w in srv.stats()["workers"]}
        states.append(st[0])
        if "quarantined" in states and st[0] == "healthy":
            break
        if "quarantined" not in states:
            srv.infer(_x(), timeout=30)
        time.sleep(0.02)
    assert "quarantined" in states and states[-1] == "healthy"
    assert _total("serving.replica.readmits") >= 1


def test_single_wedged_replica_fails_typed(servers, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_DISPATCH_TIMEOUT_S", "0.15")
    monkeypatch.setenv("MXTPU_SERVE_CANARY_S", "0.05")
    srv = ModelServer(_engine("solo"), num_workers=1, max_wait_ms=1.0,
                      warmup=True).start()
    servers.append(srv)
    chaos.configure("serving.replica0.dispatch:kind=hang,secs=2,n=50")
    t0 = time.perf_counter()
    with pytest.raises(NoHealthyReplica) as err:
        srv.infer(_x(), timeout=10)
    assert time.perf_counter() - t0 < 5.0 and err.value.server == "solo"


def test_dead_worker_is_routed_around(servers):
    srv = ModelServer(_engine("death"), num_workers=2, max_wait_ms=1.0,
                      warmup=True).start()
    servers.append(srv)
    run = srv._run_batch

    def boom(worker, batch):
        if worker.index == 0:
            raise RuntimeError("synthetic worker crash")
        return run(worker, batch)
    srv._run_batch = boom
    outs = [srv.infer(_x(seed=i), timeout=30) for i in range(4)]
    assert all(o[0].shape == (1, CLASSES) for o in outs)
    st = {w["index"]: w for w in srv.stats()["workers"]}
    assert st[0]["state"] == "dead" and st[1]["state"] == "healthy"


def test_telemetry_records_per_batch(servers, monkeypatch, tmp_path):
    path = tmp_path / "t.jsonl"
    monkeypatch.setenv("MXTPU_TELEMETRY", str(path))
    srv = ModelServer(_engine("tel"), max_wait_ms=1.0, warmup=True).start()
    servers.append(srv)
    for i in range(3):
        srv.infer(_x(2, seed=i), timeout=10)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    batches = [r for r in recs if r.get("source") == "serving"
               and "batch_size" in r]
    assert len(batches) == 3 and all(r["batch_size"] == 2 for r in batches)
    from mxnet_tpu_torch.observability import telemetry
    telemetry.close_stream()


def test_device_bytes_and_ledger_models(servers):
    memory._reset_for_tests()
    eng = _engine("bytes")
    srv = ModelServer(eng).start()
    servers.append(srv)
    assert srv.device_bytes() == eng.device_bytes() == \
        memory.model_bytes("bytes") == (CLASSES * FEATURES + CLASSES) * 4
    assert srv.ledger_models() == ["bytes"]


def test_artifact_store_names_the_unported_compile_plane(monkeypatch):
    with pytest.raises(MXNetError, match="A9"):
        ModelServer(_engine("aot"), artifacts="/nonexistent").start()
    monkeypatch.setenv("MXTPU_AOT_STORE", "/nonexistent")
    with pytest.raises(MXNetError, match="A9"):
        ModelServer(_engine("aot2")).start()


def test_cpu_server_takes_no_lease_unless_forced(servers, monkeypatch,
                                                 tmp_path):
    assert not tlease.lease_wanted(_engine("l0").device)
    path = tmp_path / "dev.lease"
    monkeypatch.setenv("MXTPU_LEASE_PATH", str(path))
    monkeypatch.setenv("MXTPU_LEASE", "1")
    srv = ModelServer(_engine("l1")).start()
    servers.append(srv)
    held = srv.stats()["lease"]
    assert held["held"] and held["holder"]["what"] == "serving"
    assert json.loads(path.read_text())["pid"] == os.getpid()
    assert srv.drain(timeout=10)
    assert not path.exists() and tlease.held_state() is None


@pytest.mark.parametrize("kind", ["forward", "decode"])
def test_sigterm_drains_in_a_child_process(kind):
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "torch_serving_drain_worker.py"),
         kind], cwd=ROOT, capture_output=True, text=True, timeout=180,
        env={k: v for k, v in os.environ.items()
             if not k.startswith("MXTPU_")})
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"kind": kind, "draining": True, "refused": True,
                   "served": 4, "drained": True, "handler_restored": True}


# -- the decode kind --------------------------------------------------------
@pytest.fixture(scope="module")
def gpt():
    np.random.seed(11)
    jblk = JaxGPT(VOCAB, **GPT_CFG)
    jblk.initialize(jmx.init.Xavier(magnitude=2.5))
    np_params = {k: np.asarray(v) for k, v in jblk.decode_params().items()}
    tblk = GPTDecoder(VOCAB, params=gpt_params_from_jax(np_params, "cpu"),
                      device="cpu", **GPT_CFG)
    return jblk, tblk


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, size=rng.randint(2, 7)) for _ in range(n)]


def test_decode_server_tokens_equal_jaxs(gpt, servers):
    jblk, tblk = gpt
    prompts = _prompts(6, seed=2)
    jsrv = JaxServer(JaxDecodeEngine(jblk, max_slots=3),
                     max_new_tokens=5).start()
    try:
        want = [jsrv.generate(p, timeout=120) for p in prompts]
    finally:
        jsrv.drain(timeout=60)
    srv = ModelServer(DecodeEngine(tblk, max_slots=3, device="cpu",
                                   name="gpt"), max_new_tokens=5).start()
    servers.append(srv)
    got = [None] * len(prompts)

    def client(i):
        got[i] = srv.generate(prompts[i], timeout=120)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    st = srv.stats()
    assert st["kind"] == "decode" and st["served"] == len(prompts)
    assert st["tokens"] == 5 * len(prompts) and st["lease"] is None
    assert srv.device_bytes() == memory.model_bytes("gpt") > 0
    assert srv.ledger_models() == ["gpt"]


def test_decode_server_drain_and_typed_refusals(gpt, servers):
    _, tblk = gpt
    srv = ModelServer(DecodeEngine(tblk, max_slots=2, device="cpu",
                                   name="gpt_drain"), max_new_tokens=4)
    with pytest.raises(MXNetError, match="before start"):
        srv.submit(np.array([1, 2]))
    with pytest.raises(MXNetError, match="coalescing knobs"):
        ModelServer(DecodeEngine(tblk, device="cpu"), max_batch_size=4)
    srv.start()
    servers.append(srv)
    handles = [srv.submit(p) for p in _prompts(4, seed=5)]
    assert srv.drain(timeout=60)
    assert all(len(h.result(timeout=1)) == 4 for h in handles)
    with pytest.raises(ServerClosed):
        srv.submit(np.array([1, 2]))
    with pytest.raises(MXNetError, match="DecodeEngine server"):
        ModelServer(_engine("fw")).generate(np.array([1]))
