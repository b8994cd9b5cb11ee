"""The planes under the port's serving stack, on the CPU: spans and
distributed traces, the device memory ledger, goodput, the health
watchdog, the device lease and the ``/metricsz`` endpoint
(`mxnet_tpu_torch.observability.{span,trace,memory,goodput,httpz}`,
`mxnet_tpu_torch.resilience.{watchdog,lease}`).

Where the JAX package has the same host function (trace contexts,
ledger arithmetic, the lease's JSON record, the Prometheus exposition),
both run on the same inputs and must agree exactly; FLOP counts are held
to the closed form exactly. Every lease here lives under `tmp_path`
(``MXTPU_LEASE_PATH``); no test touches the per-uid default lease.
"""
import json
import os
import threading
import time
import urllib.request

import jax
from jax._src import compilation_cache
import pytest
import torch

from mxnet_tpu.observability import trace as jtrace
from mxnet_tpu.resilience import lease as jlease
from mxnet_tpu_torch.context import DeviceUnreachable
from mxnet_tpu_torch.observability import goodput, httpz, memory
from mxnet_tpu_torch.observability import registry as obs
from mxnet_tpu_torch.observability import span as tspan
from mxnet_tpu_torch.observability import trace as ttrace
from mxnet_tpu_torch.resilience import chaos
from mxnet_tpu_torch.resilience import lease as tlease
from mxnet_tpu_torch.resilience.watchdog import HealthWatchdog, diagnostics


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_compile_cache():
    """JAX compiles (none are expected here) run with the session's
    persistent compile cache off (its read guard breaks under jax 0.9);
    the setting is restored, and the cache reset, after."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_LEASE_PATH", str(tmp_path / "dev.lease"))
    monkeypatch.delenv("MXTPU_LEASE", raising=False)
    chaos.configure("")
    memory._reset_for_tests()
    goodput._reset_for_tests()
    ttrace.reset_ring()
    yield
    chaos.reset()
    memory._reset_for_tests()
    goodput._reset_for_tests()


# -- spans and traces -------------------------------------------------------
@pytest.mark.parametrize("header", [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "garbage", "", None])
def test_traceparent_parse_matches_jax(header):
    j = jtrace.TraceContext.from_traceparent(header)
    t = ttrace.TraceContext.from_traceparent(header)
    assert (j is None) == (t is None)
    if j is not None:
        assert (t.trace_id, t.span_id, t.sampled) == \
            (j.trace_id, j.span_id, j.sampled)
        assert t.to_traceparent() == j.to_traceparent()


def test_step_trace_context_matches_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_GANG_DIR", "/gang/x")
    for step in (0, 7, 123):
        j = jtrace.step_trace_context("train", step)
        t = ttrace.step_trace_context("train", step)
        assert (t.trace_id, t.sampled) == (j.trace_id, j.sampled)


def test_trace_context_crosses_a_thread_hop():
    """A span opened on a worker thread under the submitting thread's
    captured context parents to the submitting span."""
    root = ttrace.TraceContext.new(sampled=True)
    got = {}
    with ttrace.trace_span("submit", ctx=root) as outer:
        captured = tspan.capture_context()

    def worker():
        with tspan.restored(captured):
            with ttrace.trace_span("work") as inner:
                got["span"] = inner.span_id
    th = threading.Thread(target=worker)
    th.start()
    th.join()
    spans = {s["name"]: s for s in ttrace.ring_spans(root.trace_id)}
    assert spans["work"]["parent_id"] == outer.span_id
    assert spans["work"]["span_id"] == got["span"]
    assert spans["submit"]["parent_id"] is None


def test_spans_are_torch_profiler_ranges():
    with tspan.span("quiet"):
        pass                      # no profiler: nothing recorded
    with torch.profiler.profile() as prof:
        with tspan.span("outer", k=2):
            with tspan.span("inner"):
                torch.ones(3) + 1
    keys = {e.key for e in prof.key_averages()}
    assert "outer[k=2]" in keys and "inner[parent=outer]" in keys


def test_trace_disabled_records_nothing(monkeypatch):
    monkeypatch.setenv("MXTPU_TRACE", "0")
    ctx = ttrace.TraceContext.new(sampled=True)
    assert ttrace.record_span("x", ctx, 0.0, 1.0) is None
    assert ttrace.ring_spans() == []


# -- the memory ledger ------------------------------------------------------
def test_ledger_arithmetic_matches_jax():
    from mxnet_tpu.observability import memory as jmemory
    jmemory._reset_for_tests()
    try:
        for mod in (memory, jmemory):
            mod.set_bytes("a", "engine", "params", 100)
            mod.set_bytes("a", "engine", "aux", 20)
            mod.set_bytes("b", "decode", "kv_cache", 400)
            mod.set_bytes("a", "engine", "aux", 30)
            mod.release("b")
            mod.set_bytes("c", "engine", "params", 5)
        for fn in ("total_bytes", "peak_bytes"):
            assert getattr(memory, fn)() == getattr(jmemory, fn)()
        assert memory.model_bytes("a") == jmemory.model_bytes("a") == 130
        assert memory.top_consumers(2) == jmemory.top_consumers(2)
        assert memory.snapshot()["models"] == jmemory.snapshot()["models"]
    finally:
        jmemory._reset_for_tests()


def test_nbytes_counts_tensor_trees():
    tree = {"w": torch.zeros(3, 4), "b": [torch.zeros(4, dtype=torch.bfloat16),
                                          None, 7]}
    assert memory.nbytes(tree) == 48 + 8


def test_chaos_oom_is_typed_with_forensics(capsys):
    memory.set_bytes("big", "engine", "params", 3 << 20)
    chaos.configure("memory.oom:p=1,kind=raise,n=1")
    with pytest.raises(memory.HBMExhausted) as err:
        with memory.oom_guard("engine.infer", "big"):
            pass
    assert err.value.report["top_consumers"][0]["model"] == "big"
    assert "[memory]   #1 big engine/params" in capsys.readouterr().err
    with memory.oom_guard("engine.infer", "big"):   # n=1: spent
        pass


def test_oom_guard_converts_out_of_memory_text():
    with pytest.raises(memory.HBMExhausted):
        with memory.oom_guard("decode.step", "m"):
            raise RuntimeError("CUDA out of memory. Tried to allocate 2 GiB")
    with pytest.raises(ValueError):
        with memory.oom_guard("decode.step", "m"):
            raise ValueError("not a memory error")


def test_device_stats_stay_off_the_cpu():
    assert memory.device_stats() is None
    assert memory.debug_section()["device"] is None
    assert memory.headroom_bytes() is None


# -- goodput ----------------------------------------------------------------
def test_flop_counter_counts_matmul_and_conv_exactly():
    a, b = torch.randn(4, 5), torch.randn(5, 6)
    out, flops = goodput.count_flops(torch.matmul, a, b)
    assert torch.equal(out, a @ b) and flops == 2 * 4 * 5 * 6
    x, w = torch.randn(2, 3, 8, 8), torch.randn(4, 3, 3, 3)
    _, flops = goodput.count_flops(torch.nn.functional.conv2d, x, w)
    assert flops == 2 * 2 * 4 * 6 * 6 * 3 * 3 * 3


def test_costs_charge_and_measured_wins():
    before = goodput.FLOPS.total()
    goodput.record_cost("p", flops=10.0)
    goodput.record_cost("p", flops=40.0, measured=True)
    assert goodput.record_cost("p", flops=99.0)["flops"] == 40.0
    assert goodput.note_dispatch("p", n=3) == 120.0
    assert goodput.FLOPS.total() - before == 120.0
    assert goodput.note_dispatch("unregistered") == 0.0
    assert goodput.costs_snapshot()["p"]["source"] == "measured"


# -- the watchdog -----------------------------------------------------------
def test_dispatch_trip_raises_the_ports_device_unreachable():
    wd = HealthWatchdog()
    before = obs.REGISTRY.get("resilience.watchdog.trips").get(
        kind="dispatch")
    with pytest.raises(DeviceUnreachable) as err:
        wd.guard_dispatch(lambda: time.sleep(2.0), what="probe",
                          timeout_s=0.2)
    assert "probe did not complete" in str(err.value)
    assert err.value.diagnostics is not None
    assert obs.REGISTRY.get("resilience.watchdog.trips").get(
        kind="dispatch") == before + 1
    assert wd.guard_dispatch(lambda: 5, timeout_s=1.0) == 5
    assert wd.guard_dispatch(lambda: 6, timeout_s=0) == 6


def test_a_wedged_guard_worker_leaves_later_dispatches_bounded():
    """While the persistent worker still holds a tripped dispatch, the
    next guarded dispatch runs on a fresh thread and answers in time."""
    wd = HealthWatchdog()
    release = threading.Event()
    with pytest.raises(DeviceUnreachable):
        wd.guard_dispatch(lambda: release.wait(10), timeout_s=0.1)
    t0 = time.monotonic()
    assert wd.guard_dispatch(lambda: 7, timeout_s=2.0) == 7
    assert time.monotonic() - t0 < 1.0
    release.set()


def test_diagnostics_name_the_lease_holder(tmp_path):
    path = str(tmp_path / "dev.lease")
    assert "no holder recorded" in diagnostics(path)
    with tlease.DeviceLease(path=path, what="serving"):
        assert "holder pid %d" % os.getpid() in diagnostics(path)


# -- the device lease -------------------------------------------------------
def test_lease_record_and_path_match_jax(tmp_path, monkeypatch):
    assert tlease.default_lease_path() == jlease.default_lease_path()
    monkeypatch.delenv("MXTPU_LEASE_PATH")
    assert tlease.default_lease_path() == jlease.default_lease_path()
    path = str(tmp_path / "x.lease")
    with tlease.DeviceLease(path=path, what="gateway") as dl:
        rec = jlease.read_lease(path)      # the JAX reader reads ours
        assert rec["pid"] == os.getpid() and rec["what"] == "gateway"
        assert sorted(rec) == sorted(jlease.DeviceLease(
            path=path)._my_record())
        assert dl.refresh()
    assert not os.path.exists(path)


def test_lease_wanted_decides_from_the_target_device(monkeypatch):
    import mxnet_tpu_torch as mx
    assert tlease.lease_wanted("cuda") and tlease.lease_wanted(
        torch.device("cuda", 0)) and tlease.lease_wanted(mx.gpu(0))
    assert not tlease.lease_wanted("cpu")
    assert not tlease.lease_wanted(mx.cpu())
    with mx.cpu():
        assert not tlease.lease_wanted()
    monkeypatch.setenv("MXTPU_LEASE", "1")
    assert tlease.lease_wanted("cpu")
    monkeypatch.setenv("MXTPU_LEASE", "0")
    assert not tlease.lease_wanted("cuda")


def test_dead_holder_is_taken_over_and_live_one_refused(tmp_path):
    path = str(tmp_path / "dev.lease")
    dead = {"pid": 2 ** 22 + 12345, "host": __import__("socket")
            .gethostname(), "created": time.time(),
            "heartbeat": time.time(), "what": "old"}
    with open(path, "w") as f:
        json.dump(dead, f)
    dl = tlease.DeviceLease(path=path, takeover_s=60)
    dl.acquire(timeout=5)
    assert dl.takeovers == 1 and dl.taken_over_from["what"] == "old"
    with pytest.raises(tlease.LeaseHeld) as err:
        tlease.DeviceLease(path=path, takeover_s=60).acquire(timeout=0.3)
    assert err.value.holder["pid"] == os.getpid()
    dl.release()


def test_process_hold_is_refcounted(tmp_path):
    a = tlease.hold(what="serving")
    b = tlease.hold(what="gateway")
    assert a is b and tlease.held_state()["held"]
    tlease.release_hold()
    assert tlease.held_state() is not None
    tlease.release_hold()
    assert tlease.held_state() is None
    assert not os.path.exists(str(tmp_path / "dev.lease"))


# -- /metricsz, /debugz -----------------------------------------------------
def test_observability_server_binds_port_zero_and_serves():
    obs.counter("planes.test.count", "a counter").inc(3, model="m")
    with httpz.ObservabilityServer(port=0) as srv:
        assert srv.port > 0
        text = urllib.request.urlopen(srv.url + "/metricsz").read().decode()
        assert 'mxtpu_planes_test_count_total{model="m"} 3' in text
        snap = json.loads(urllib.request.urlopen(srv.url + "/debugz").read())
        assert {"memory", "goodput", "lease", "threads", "trace"} <= set(snap)
        assert json.loads(urllib.request.urlopen(
            srv.url + "/healthz").read()) == {"ok": True}


def test_metrics_port_env_offsets_by_rank_and_zero_is_off(monkeypatch):
    monkeypatch.setenv("MXTPU_METRICS_PORT", "0")
    assert httpz.maybe_start() is None
    monkeypatch.setenv("MXTPU_METRICS_PORT", "41000")
    monkeypatch.setenv("DMLC_WORKER_ID", "3")
    assert httpz.ObservabilityServer()._port == 41003
    assert httpz.ObservabilityServer(port=41000)._port == 41000


def test_prometheus_exposition_matches_jax():
    from mxnet_tpu.observability.registry import MetricsRegistry as JReg
    regs = [obs.MetricsRegistry(), JReg()]
    for r in regs:
        r.counter("a.b.count", "c").inc(2, k='x"y')
        r.gauge("g.bytes", "g").set(5)
        h = r.histogram("h.seconds", "h", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 2.0):
            h.observe(v, server="s")
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
