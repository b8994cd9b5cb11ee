"""The port's per-step telemetry (mxnet_tpu_torch/observability/
telemetry.py: `StepTimer`, its phases, the counter snapshot) against the
JAX package's, on the CPU:

- a bare `StepTimer`'s records have the JAX records' keys, step numbers
  and phase fields (JAX tests/test_observability.py:210);
- a 5-step `gluon.Trainer` run streams one ``source: "gluon.trainer"``
  record a step with the JAX run's keys, staged and fused (:262), and
  `Module.fit` one ``module.fit`` record a batch with its phases (:319);
- `tools/telemetry_report.py` and `tools/perf_gate.py` read the port's
  stream unchanged (subprocesses);
- the counter snapshot covers JAX's fields but the compile cache's
  (ROADMAP A9b), and the port counts its own builds as compiles.
"""
import json
import os
import subprocess
import sys

import numpy as np
import jax
from jax._src import compilation_cache
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.observability import telemetry as jtele
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.observability import telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the JAX records carry and the port's cannot yet: the persistent
# compile cache's counters (ROADMAP A9b), and goodput's FLOPs and MFU,
# which JAX charges for its compiled programs and the port for its
# serving buckets only
JAX_ONLY = {"compile_cache_hits", "compile_cache_misses", "step_flops",
            "mfu"}
# the deltas a record carries only when their counter moved in the step
# (JAX telemetry.py:351-361): which move is the implementation's (the
# port's fused step counts its update groups, JAX's its bucket packing)
OPTIONAL = set(telemetry._OPTIONAL) | JAX_ONLY


def _same_schema(port, ref):
    """The port's record has the JAX record's fixed keys, and its optional
    deltas are among the JAX schema's."""
    assert set(port) - OPTIONAL == set(ref) - OPTIONAL, (sorted(port),
                                                         sorted(ref))
    assert set(port) & OPTIONAL <= OPTIONAL - JAX_ONLY


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


@pytest.fixture(autouse=True)
def _streams_closed(monkeypatch):
    monkeypatch.delenv("MXTPU_TELEMETRY", raising=False)
    telemetry.close_stream()
    jtele.close_stream()
    yield
    telemetry.close_stream()
    jtele.close_stream()


def _read(path, source=None):
    recs = [json.loads(line) for line in open(path)]
    return [r for r in recs if source is None or r.get("source") == source]


def _stream(monkeypatch, path, run):
    monkeypatch.setenv("MXTPU_TELEMETRY", str(path))
    try:
        run()
    finally:
        telemetry.close_stream()
        jtele.close_stream()
        monkeypatch.delenv("MXTPU_TELEMETRY")


def test_bare_step_timer_records_match_jax(tmp_path, monkeypatch):
    def run(timer_cls, n=3):
        timer = timer_cls("unit.test")
        recs = []
        for i in range(n):
            timer.begin_step()
            with timer.phase("optimizer"):
                pass
            with timer.phase("numerics"):
                pass
            recs.append(timer.end_step(batch_size=4, tag="x"))
        return recs

    _stream(monkeypatch, tmp_path / "port.jsonl",
            lambda: run(telemetry.StepTimer))
    _stream(monkeypatch, tmp_path / "jax.jsonl",
            lambda: run(jtele.StepTimer))
    port = _read(tmp_path / "port.jsonl")
    ref = _read(tmp_path / "jax.jsonl")
    assert [r["step"] for r in port] == [r["step"] for r in ref] == [0, 1, 2]
    for p, j in zip(port, ref):
        _same_schema(p, j)
        assert p["source"] == "unit.test" and p["tag"] == "x"
        assert p["step_time"] >= p["optimizer_time"] >= 0
        assert p["samples_per_sec"] == 4 / p["step_time"]
    # streaming off: the record still comes back
    rec = telemetry.StepTimer("unit.nostream")
    rec.begin_step()
    assert rec.end_step()["step"] == 0


def test_counter_snapshot_covers_jaxs_fields():
    port = telemetry._counters_snapshot()
    ref = jtele._counters_snapshot()
    assert set(port) == set(ref) - {"compile_cache_hits",
                                    "compile_cache_misses"}
    assert set(telemetry._OPTIONAL) <= set(port)


def _rng_data(n_steps, batch):
    x = np.random.RandomState(0).rand(n_steps * batch, 8).astype(np.float32)
    y = np.random.RandomState(1).rand(n_steps * batch, 4).astype(np.float32)
    return x, y


def _port_gluon(n_steps, batch=8):
    x, y = _rng_data(n_steps, batch)
    with mx.cpu():
        net = gluon.nn.Dense(4, in_units=8)
        net.initialize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        loss_fn = gluon.loss.L2Loss()
        for i in range(n_steps):
            xb = torch.from_numpy(x[i * batch:(i + 1) * batch])
            yb = torch.from_numpy(y[i * batch:(i + 1) * batch])
            with autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(batch)


def _jax_gluon(n_steps, batch=8):
    x, y = _rng_data(n_steps, batch)
    net = jgluon.nn.Dense(4, in_units=8)
    net.initialize()
    trainer = jgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1})
    loss_fn = jgluon.loss.L2Loss()
    for i in range(n_steps):
        xb = jmx.nd.array(x[i * batch:(i + 1) * batch])
        yb = jmx.nd.array(y[i * batch:(i + 1) * batch])
        with jautograd.record():
            loss = loss_fn(net(xb), yb)
        loss.backward()
        trainer.step(batch)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_gluon_five_steps_stream_jax_schema(tmp_path, monkeypatch, fused):
    monkeypatch.setenv("MXTPU_FUSED_STEP", fused)
    from mxnet_tpu.compile import coldstart
    coldstart.mark_ready("test-setup")   # JAX's once-a-process record
    _stream(monkeypatch, tmp_path / "port.jsonl", lambda: _port_gluon(5))
    _stream(monkeypatch, tmp_path / "jax.jsonl", lambda: _jax_gluon(5))
    port = _read(tmp_path / "port.jsonl", "gluon.trainer")
    ref = _read(tmp_path / "jax.jsonl", "gluon.trainer")
    assert len(port) == len(ref) == 5
    assert [r["step"] for r in port] == list(range(5))
    phases = {"step_time"} if fused == "1" else \
        {"allreduce_time", "optimizer_time"}
    for p, j in zip(port, ref):
        # the JAX trainer pushes through a local store, the port's makes
        # none in one process (gluon/trainer.py), so only the byte count
        # differs, not the key
        _same_schema(p, j)
        assert phases | {"numerics_time", "batch_size"} <= set(p)
        assert p["batch_size"] == 8 and p["step_time"] > 0
    if fused == "1":
        assert all(r["step_dispatches"] == 1 for r in port)
    # the backend-neutral tools read it unchanged
    report = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "telemetry_report.py"),
         "--json", str(tmp_path / "port.jsonl")], capture_output=True,
        text=True, timeout=120)
    assert report.returncode == 0, report.stderr
    summary = json.loads(report.stdout)
    assert summary["steps"] == 5 and summary["samples"] == 40
    text = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "telemetry_report.py"),
         str(tmp_path / "port.jsonl")], capture_output=True, text=True,
        timeout=120)
    assert text.returncode == 0 and "p50" in text.stdout
    gate = [sys.executable, os.path.join(ROOT, "tools", "perf_gate.py"),
            str(tmp_path / "port.jsonl"), "--max-skipped-steps", "0"]
    if fused == "1":
        gate += ["--max-dispatches-per-step", "1"]
    proc = subprocess.run(gate, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout)["ok"]


def test_module_fit_records_match_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(7)
    x = rng.randn(40, 8).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)

    def port():
        with mx.cpu():
            train = mx.io.NDArrayIter(x, y, batch_size=8)
            h = mx.sym.FullyConnected(data=mx.sym.var("data"), num_hidden=2,
                                      name="fc1")
            sym = mx.sym.SoftmaxOutput(data=h, name="softmax")
            mod = mx.mod.Module(sym, context=mx.cpu())
            mod.fit(train, num_epoch=1, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1})

    def ref():
        train = jmx.io.NDArrayIter(x, y, batch_size=8)
        h = jmx.sym.FullyConnected(data=jmx.sym.var("data"), num_hidden=2,
                                   name="fc1")
        sym = jmx.sym.SoftmaxOutput(data=h, name="softmax")
        mod = jmx.Module(sym, context=jmx.cpu())
        mod.fit(train, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1})

    from mxnet_tpu.compile import coldstart
    coldstart.mark_ready("test-setup")
    _stream(monkeypatch, tmp_path / "port.jsonl", port)
    _stream(monkeypatch, tmp_path / "jax.jsonl", ref)
    precs = _read(tmp_path / "port.jsonl", "module.fit")
    jrecs = _read(tmp_path / "jax.jsonl", "module.fit")
    assert len(precs) == len(jrecs) == 5
    for p, j in zip(precs, jrecs):
        _same_schema(p, j)
        for k in ("forward_backward_time", "optimizer_time",
                  "numerics_time"):
            assert p[k] >= 0, k
        assert p["step_time"] > 0
        assert (p["epoch"], p["nbatch"]) == (j["epoch"], j["nbatch"])


def test_graph_builds_count_as_compiles():
    before = telemetry.COMPILE_COUNT.total()
    timer = telemetry.StepTimer("unit.compile")
    timer.begin_step()
    with mx.cpu():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(4, in_units=8))
        net.initialize()
        net.hybridize()
        net(torch.zeros(2, 8))
    rec = timer.end_step()
    assert rec["compile_count"] >= 1 and rec["compile_seconds"] >= 0
    assert telemetry.COMPILE_COUNT.total() - before == rec["compile_count"]
    timer.begin_step()
    with mx.cpu():
        net(torch.zeros(2, 8))           # the built graph is reused
    assert timer.end_step()["compile_count"] == 0
