"""The port's `ModelRegistry` and HTTP `Gateway` on the CPU, held to the
JAX package's registry, admission and servers called directly in this
process (the JAX package's own HTTP tests fail in the full suite, so
they are no oracle).

- Registry: the same sequence of loads under the same byte budget gives
  the same resident sets, LRU evictions and reload counts in both
  packages; concurrent gets of a cold model build it once; a failing
  builder returns the model to cold.
- Admission: the same arrivals are granted in the same strict priority
  order, and shed with the same errors, as JAX's `_Admission`.
- The slice as a whole: a Gateway on 127.0.0.1:0 over a registry holding
  a forward model (bucketed `InferenceEngine` behind a `ModelServer`)
  and a decode model (`DecodeEngine` behind one). ``:predict`` answers
  byte for byte what the port's engine answers directly and within 1e-5
  of the JAX engine; ``:generate``, streamed and not, gives exactly the
  tokens of JAX's decode `ModelServer` on the same weights; eviction and
  a transparent reload under a budget between the two models' bytes;
  ``/readyz`` flips only after every eager warm-up.

Every registry and gateway is closed by a fixture finalizer; ports are
port 0; chaos is reset after each test.
"""
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import jax
from jax._src import compilation_cache
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo.gpt import GPTDecoder as JaxGPT
from mxnet_tpu.serving import DecodeEngine as JaxDecodeEngine
from mxnet_tpu.serving import InferenceEngine as JaxEngine
from mxnet_tpu.serving import ModelRegistry as JaxRegistry
from mxnet_tpu.serving import ModelServer as JaxServer
from mxnet_tpu.serving.gateway.frontdoor import _Admission as JaxAdmission
from mxnet_tpu.resilience import Deadline as JaxDeadline
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import gpt_params_from_jax
from mxnet_tpu_torch.gluon.model_zoo import GPTDecoder
from mxnet_tpu_torch.observability import memory
from mxnet_tpu_torch.resilience import Deadline, chaos
from mxnet_tpu_torch.serving import (DecodeEngine, Gateway, InferenceEngine,
                                     ModelRegistry, PRIORITY_CLASSES,
                                     ServerClosed)
from mxnet_tpu_torch.serving.gateway.frontdoor import _Admission

TOL = 1e-5
FEATURES, CLASSES = 6, 3
VOCAB = 64
GPT_CFG = dict(max_seq_len=32, num_layers=2, num_heads=2, embed_dim=16)


SERVER_THREADS = ("serving-worker", "serving-dispatch", "serving-canary",
                  "decode-sched", "decode-signal-watch", "gateway-http",
                  "gateway-evict", "lease-heartbeat")


@pytest.fixture(scope="module", autouse=True)
def _isolation():
    """JAX compiles run with the session's persistent compile cache off
    (its read guard breaks under jax 0.9), restored and reset after; no
    server, gateway or registry thread this module started outlives
    it."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    before = {t.ident for t in threading.enumerate()}
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


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_LEASE_PATH", str(tmp_path / "dev.lease"))
    for k in ("MXTPU_LEASE", "MXTPU_TELEMETRY", "MXTPU_GATEWAY_HEDGE_MS",
              "MXTPU_SERVE_DISPATCH_TIMEOUT_S"):
        monkeypatch.delenv(k, raising=False)
    chaos.configure("")
    yield
    chaos.reset()


@pytest.fixture
def closing():
    """Registries and gateways a test opens, closed when it ends."""
    opened = []
    yield opened
    for obj in reversed(opened):
        if isinstance(obj, Gateway):
            obj.close(timeout=30)
        else:
            obj.drain_all(timeout=30)


def _mlp_args(seed, hidden):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": (rng.randn(hidden, FEATURES) * 0.5)
            .astype(np.float32),
            "fc1_bias": rng.randn(hidden).astype(np.float32)}


def _mlp_sym(mx, hidden):
    with mx.name.NameManager():
        h = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=hidden,
                                  name="fc1")
        return mx.sym.SoftmaxOutput(h, name="softmax")


def _builder(pkg, seed, name, hidden=CLASSES):
    """A zero-arg builder of an MLP engine in `pkg` ("jax"/"port")."""
    def build():
        args = _mlp_args(seed, hidden)
        if pkg == "jax":
            return JaxEngine.from_symbol(
                _mlp_sym(jmx, hidden),
                {k: jmx.nd.array(v) for k, v in args.items()}, {},
                {"data": (FEATURES,)}, 4, name=name)
        return InferenceEngine.from_symbol(
            _mlp_sym(tmx, hidden), args, {}, {"data": (FEATURES,)}, 4,
            name=name, device="cpu")
    return build


def _x(n=1, seed=7):
    return np.random.RandomState(seed).randn(n, FEATURES).astype(np.float32)


# -- the registry, against JAX's -------------------------------------------
SIZES = {"a": 3, "b": 5, "c": 4}
SEQUENCE = ("a", "b", "a", "c", "b", "a", "c", "c", "b")


def _registry_trace(pkg, budget):
    """Resident sets and reload counts after each get of SEQUENCE."""
    reg = (JaxRegistry if pkg == "jax" else ModelRegistry)()
    for i, (name, hidden) in enumerate(sorted(SIZES.items())):
        reg.register(name, _builder(pkg, i, "%s_%s" % (pkg, name), hidden),
                     num_workers=1, max_wait_ms=1.0)
    reg.set_budget(budget_bytes=budget)
    trace, byts = [], {}
    try:
        for name in SEQUENCE:
            out = reg.get(name).infer(_x(), timeout=30)
            assert np.asarray(out[0]).shape == (1, SIZES[name])
            byts[name] = reg.stats()["models"][name]["bytes"]
            trace.append((reg.resident(), reg.stats()["reloads"]))
    finally:
        assert reg.drain_all(timeout=30)
    return trace, byts


@pytest.mark.parametrize("fits", [1, 2, 3])
def test_registry_lru_and_budget_match_jax(fits):
    """A byte budget that fits the `fits` largest models: the same
    evictions (coldest first), resident sets and reloads. The port's
    worker on the engine's own device serves from the engine's
    parameters, so a model counts its parameter bytes once; JAX's
    places a second copy for its worker's device and counts both
    (JAX engine.py:542), so its budget is twice the port's."""
    per = {n: (h * FEATURES + h) * 4 for n, h in SIZES.items()}
    budget = sum(sorted(per.values())[-fits:])
    port, pbytes = _registry_trace("port", budget)
    jax_, jbytes = _registry_trace("jax", 2 * budget)
    assert pbytes == per
    assert jbytes == {n: 2 * b for n, b in per.items()}
    assert port == jax_


def test_registry_single_flight_and_builder_failure(closing):
    calls, state = [], {"fail": True}

    def slow():
        calls.append(1)
        time.sleep(0.2)
        return _builder("port", 5, "single")()

    def flaky():
        if state["fail"]:
            raise RuntimeError("flaky load")
        return _builder("port", 2, "flaky")()
    reg = ModelRegistry()
    closing.append(reg)
    reg.register("s", slow, num_workers=1, max_wait_ms=1.0)
    reg.register("f", flaky, num_workers=1)
    reg.get("s")
    assert reg.evict("s", timeout=30)
    got = []
    threads = [threading.Thread(target=lambda: got.append(reg.get("s")))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 2 and all(s is got[0] for s in got)
    assert reg.stats()["reloads"] == 1
    with pytest.raises(RuntimeError, match="flaky"):
        reg.get("f")
    assert reg.stats()["models"]["f"]["state"] == "cold"
    state["fail"] = False
    assert reg.get("f") is reg.get("f")
    with pytest.raises(MXNetError, match="unknown model"):
        reg.get("nope")
    with pytest.raises(MXNetError, match="name"):
        reg.register("bad:name", slow)


def test_eviction_releases_the_ledger_and_drain_all_is_terminal(closing):
    memory._reset_for_tests()
    reg = ModelRegistry(max_models=1)
    closing.append(reg)
    reg.register("p", _builder("port", 0, "ledger_p"), num_workers=1)
    reg.register("q", _builder("port", 1, "ledger_q"), num_workers=1)
    reg.get("p")
    assert memory.model_bytes("ledger_p") == reg.stats()["models"]["p"][
        "bytes"] > 0
    reg.get("q")
    t0 = time.monotonic()
    while reg.resident() != ["q"] and time.monotonic() - t0 < 10:
        time.sleep(0.01)
    assert reg.resident() == ["q"] and memory.model_bytes("ledger_p") == 0
    assert reg.drain_all(timeout=30)
    with pytest.raises(ServerClosed) as err:
        reg.get("p")
    assert err.value.server == "p"


# -- admission, against JAX's ----------------------------------------------
def _grant_order(adm_cls, arrivals):
    """Take the one slot, queue `arrivals` (classes, in arrival order),
    free the slot; the classes in the order they were granted."""
    adm = adm_cls(concurrency=1, queue_depth=8)
    adm.enter("best_effort")
    order, threads = [], []
    lock = threading.Lock()

    def waiter(cls):
        adm.enter(cls)
        with lock:
            order.append(cls)
        adm.leave()
    for i, cls in enumerate(arrivals):
        t = threading.Thread(target=waiter, args=(cls,))
        t.start()
        threads.append(t)
        while sum(adm.queue_depths().values()) < i + 1:
            time.sleep(0.005)
    adm.leave()
    for t in threads:
        t.join(10)
    return order


@pytest.mark.parametrize("arrivals", [
    ("best_effort", "batch", "interactive"),
    ("batch", "interactive", "best_effort", "interactive", "batch"),
    ("interactive",) * 3 + ("best_effort",)])
def test_admission_grants_match_jax(arrivals):
    port = _grant_order(_Admission, arrivals)
    assert port == _grant_order(JaxAdmission, arrivals)
    assert port == sorted(arrivals, key=PRIORITY_CLASSES.index)


def test_admission_sheds_like_jax():
    outcomes = []
    for adm_cls, dl in ((_Admission, Deadline), (JaxAdmission, JaxDeadline)):
        adm = adm_cls(concurrency=1, queue_depth=1)
        adm.enter("interactive")
        blocker = threading.Thread(
            target=lambda: (adm.enter("best_effort"), adm.leave()))
        blocker.start()
        while adm.queue_depths()["best_effort"] < 1:
            time.sleep(0.005)
        got = []
        for cls, deadline in (("best_effort", None),
                              ("interactive", dl(0.0)), ("vip", None)):
            try:
                adm.enter(cls, deadline)
                got.append("granted")
            except Exception as err:  # noqa: BLE001 — compared by type
                got.append(type(err).__name__)
        adm.leave()
        blocker.join(10)
        outcomes.append((got, dict(adm.shed)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ["RequestRejected", "DeadlineExceeded",
                              "MXNetError"]


# -- the slice as a whole: Gateway -> Registry -> both server kinds ---------
@pytest.fixture(scope="module")
def gpt():
    np.random.seed(13)
    jblk = JaxGPT(VOCAB, **GPT_CFG)
    jblk.initialize(jmx.init.Xavier(magnitude=2.5))
    params = {k: np.asarray(v) for k, v in jblk.decode_params().items()}
    return jblk, params


def _port_gpt(params):
    return GPTDecoder(VOCAB, params=gpt_params_from_jax(params, "cpu"),
                      device="cpu", **GPT_CFG)


@pytest.fixture(scope="module")
def gateway(gpt):
    _, params = gpt
    reg = ModelRegistry()
    reg.register("mlp", _builder("port", 0, "gw_mlp"), eager=True,
                 num_workers=1, max_wait_ms=1.0)
    reg.register("gpt", lambda: DecodeEngine(
        _port_gpt(params), max_slots=2, device="cpu", name="gw_gpt"),
        eager=True, max_new_tokens=6)
    with tmx.cpu():
        gw = Gateway(reg, port=0).start()
    yield gw
    assert gw.close(timeout=60)


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode("utf-8"))
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode("utf-8"))


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode("utf-8"))
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode("utf-8"))


def test_http_predict_is_byte_identical_to_direct_infer(gateway):
    assert gateway.port > 0 and gateway.ready()
    direct_eng = _builder("port", 0, "direct")()
    jax_eng = _builder("jax", 0, "direct_jax")()
    for n in (1, 3, 4):
        x = _x(n, seed=n)
        st, body = _post(gateway.url + "/v1/models/mlp:predict",
                         {"inputs": x.tolist()})
        assert st == 200, body
        got = np.asarray(body["outputs"][0], np.float32)
        direct = direct_eng.infer(x)[0].asnumpy()
        assert got.tobytes() == direct.tobytes()
        np.testing.assert_allclose(got, jax_eng.infer(x)[0].asnumpy(),
                                   rtol=TOL, atol=TOL)


def test_http_generate_stream_and_not_equal_jaxs_tokens(gateway, gpt):
    jblk, _ = gpt
    prompts = [[2, 5, 8], [7, 1, 9, 4, 3]]
    jsrv = JaxServer(JaxDecodeEngine(jblk, max_slots=2),
                     max_new_tokens=6).start()
    try:
        want = [list(map(int, jsrv.generate(np.asarray(p, np.int32),
                                            timeout=120)))
                for p in prompts]
    finally:
        jsrv.drain(timeout=60)
    for prompt, expect in zip(prompts, want):
        st, body = _post(gateway.url + "/v1/models/gpt:generate",
                         {"tokens": prompt, "max_new_tokens": 6})
        assert st == 200 and body["tokens"] == expect, body
        req = urllib.request.Request(
            gateway.url + "/v1/models/gpt:generate",
            data=json.dumps({"tokens": prompt, "max_new_tokens": 6,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            lines = [json.loads(line) for line in
                     r.read().decode().splitlines()]
        assert [line["token"] for line in lines if "token" in line] == \
            expect
        tail = dict(lines[-1])
        tail.pop("trace_id", None)
        assert tail == {"done": True, "tokens": 6}


def test_http_eviction_and_transparent_reload_under_budget(gateway):
    reg = gateway.registry
    sizes = reg.stats()["models"]
    small, big = sorted(("mlp", "gpt"), key=lambda m: sizes[m]["bytes"])
    assert 0 < sizes[small]["bytes"] < sizes[big]["bytes"]
    reg.set_budget(budget_bytes=sizes[big]["bytes"] + 1)
    try:
        x = _x(2, seed=3)
        st, before = _post(gateway.url + "/v1/models/mlp:predict",
                           {"inputs": x.tolist()})
        st2, toks = _post(gateway.url + "/v1/models/gpt:generate",
                          {"tokens": [3, 4], "max_new_tokens": 4})
        assert st == st2 == 200
        t0 = time.monotonic()
        while len(reg.resident()) > 1 and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert reg.resident() == ["gpt"]
        reloads = reg.stats()["reloads"]
        st, after = _post(gateway.url + "/v1/models/mlp:predict",
                          {"inputs": x.tolist()})
        assert st == 200 and after["outputs"] == before["outputs"]
        assert reg.stats()["reloads"] == reloads + 1
        t0 = time.monotonic()
        while reg.resident() != ["mlp"] and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        st, again = _post(gateway.url + "/v1/models/gpt:generate",
                          {"tokens": [3, 4], "max_new_tokens": 4})
        assert st == 200 and again["tokens"] == toks["tokens"]
    finally:
        reg.set_budget(budget_bytes=0)


def test_http_errors_shed_and_keep_alive(gateway):
    x = [[0.0] * FEATURES]
    st, body = _post(gateway.url + "/v1/models/mlp:predict",
                     {"inputs": x, "deadline_ms": 0})
    assert st == 504 and "shed before compute" in body["error"]
    st, body = _post(gateway.url + "/v1/models/nope:predict", {"inputs": x})
    assert st == 404 and "unknown model" in body["error"]
    st, body = _post(gateway.url + "/v1/models/mlp:predict",
                     {"inputs": x, "priority": "vip"})
    assert st == 400
    conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=30)
    try:
        def post(path, payload):
            conn.request("POST", path, body=json.dumps(payload))
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        assert post("/nope", {"inputs": x})[0] == 404
        assert post("/v1/models/mlp:predict", {"inputs": x})[0] == 200
        st, body = post("/v1/models/mlp:predict", {"inputs": [[1, 2], [3]]})
        assert st == 400 and "ValueError" in body["error"]
        st, body = post("/v1/models/mlp:generate", {"tokens": [1]})
        assert st == 400 and "decode" in body["error"]
        assert post("/v1/models/gpt:generate",
                    {"tokens": [1], "max_new_tokens": "lots"})[0] == 400
        assert post("/v1/models/mlp:predict", {"inputs": x})[0] == 200
    finally:
        conn.close()
    chaos.configure("gateway.admit:kind=fatal,n=1")
    st, body = _post(gateway.url + "/v1/models/mlp:predict", {"inputs": x})
    assert st == 500 and "chaos" in body["error"]
    st, _ = _post(gateway.url + "/v1/models/mlp:predict", {"inputs": x})
    assert st == 200


def test_http_health_metrics_and_debug(gateway):
    st, body = _get(gateway.url + "/healthz")
    assert st == 200 and body == {"ok": True, "draining": False,
                                  "lease": None}
    with urllib.request.urlopen(gateway.url + "/metricsz") as r:
        text = r.read().decode()
    assert "mxtpu_serving_gateway_requests_total" in text
    st, body = _get(gateway.url + "/debugz")
    assert st == 200 and "gateway" in body and "memory" in body
    st, body = _get(gateway.url + "/v1/models")
    assert sorted(body["models"]["models"]) == ["gpt", "mlp"]


def test_readyz_flips_only_after_every_eager_warmup(closing):
    gate = threading.Event()

    def slow(seed):
        def build():
            gate.wait(30)
            return _builder("port", seed, "slow%d" % seed)()
        return build
    reg = ModelRegistry()
    reg.register("a", slow(0), eager=True, num_workers=1)
    reg.register("b", slow(1), eager=True, num_workers=1)
    with tmx.cpu():
        gw = Gateway(reg, port=0, concurrency=2)
    closing.append(gw)
    boot = threading.Thread(target=gw.start, daemon=True)
    boot.start()
    try:
        t0 = time.monotonic()
        while not gw._started and time.monotonic() - t0 < 10:
            time.sleep(0.02)
        st, body = _get(gw.url + "/readyz")
        assert st == 503 and body["ready"] is False
        assert _get(gw.url + "/healthz")[0] == 200
    finally:
        gate.set()
    boot.join(timeout=60)
    st, body = _get(gw.url + "/readyz")
    assert st == 200 and sorted(body["resident"]) == ["a", "b"]
    assert gw.close(timeout=30)
    # a closed gateway restarts: start() reopens the registry
    gw2 = Gateway(reg, port=0, device="cpu").start()
    closing.append(gw2)
    st, _ = _post(gw2.url + "/v1/models/a:predict",
                  {"inputs": _x().tolist()})
    assert st == 200


def test_cpu_gateway_takes_no_lease_unless_forced(closing, monkeypatch,
                                                  tmp_path):
    reg = ModelRegistry()
    reg.register("m", _builder("port", 0, "lease_m"), num_workers=1)
    with tmx.cpu():
        gw = Gateway(reg, port=0).start()
    closing.append(gw)
    assert not gw._leased
    gw.close(timeout=30)
    monkeypatch.setenv("MXTPU_LEASE", "1")
    gw2 = Gateway(reg, port=0, device="cpu").start()
    closing.append(gw2)
    assert gw2._leased
    assert json.loads((tmp_path / "dev.lease").read_text())["what"] == \
        "gateway"
    gw2.close(timeout=30)
    assert not (tmp_path / "dev.lease").exists()
