"""The port's `monitor` and `profiler` (mxnet_tpu_torch/monitor.py,
mxnet_tpu_torch/profiler.py) against the JAX package's, on the CPU:

- a `Monitor` installed on a bound executor collects the same stat names
  (outputs, arguments, ``grad_`` gradients), in the same order, with the
  same values (1e-5) as the JAX package's over the same weights and
  batch; its interval and pattern act the same; `Module.fit(monitor=)`
  prints what it collects;
- a `profiler.dump` is one chrome trace in the JAX dump's schema: the
  process metadata, the scoped objects' and operators' "X" events, the
  markers and the "C" counter rows carry the JAX events' keys and
  categories, and the training loop's ``step/<phase>`` spans and torch's
  own events land in the same file; `dumps` prints the aggregate table;
- a torch profiler session already recording makes ``set_state("run")``
  raise instead of nesting.

The JAX profiler's own session is not run here (its device trace is
jax.profiler's); its host events are built through its event recorder.
"""
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import monitor as jmonitor
from mxnet_tpu import profiler as jprof
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, monitor, profiler

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_symbolic_parity import (  # noqa: E402,F401
    no_persistent_compile_cache, restore_shared_state)

pytestmark = pytest.mark.usefixtures("restore_shared_state")


def _mlp(mx):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        h = mx.sym.FullyConnected(data, num_hidden=6, name="fc1")
        h = mx.sym.Activation(h, act_type="relu")
        h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
        return mx.sym.SoftmaxOutput(h, name="softmax")


def _bound():
    jex = _mlp(jmx).simple_bind(jmx.cpu(), data=(4, 5))
    tex = _mlp(tmx).simple_bind(tmx.cpu(), data=(4, 5))
    rng = np.random.RandomState(0)
    for k, arr in jex.arg_dict.items():
        v = rng.randint(0, 3, arr.shape) if k.endswith("label") \
            else rng.randn(*arr.shape) * 0.5
        arr[:] = v.astype(np.float32)
        tex.arg_dict[k][:] = v.astype(np.float32)
    return jex, tex


@pytest.mark.parametrize("pattern,sort", [(".*", False), ("fc1.*", True)])
def test_monitor_stats_match_jax(pattern, sort):
    jex, tex = _bound()
    jmon = jmonitor.Monitor(2, pattern=pattern, sort=sort)
    tmon = monitor.Monitor(2, pattern=pattern, sort=sort)
    jmon.install(jex)
    tmon.install(tex)
    got = []
    for _ in range(3):
        rows = []
        for mon, ex in ((jmon, jex), (tmon, tex)):
            mon.tic()
            ex.forward(is_train=True)
            ex.backward()
            rows.append(mon.toc())
        got.append(rows)
    for step, (jrows, trows) in enumerate(got):
        assert [(n, k) for n, k, _ in trows] == \
            [(n, k) for n, k, _ in jrows], step
        for (_, k, jv), (_, _, tv) in zip(jrows, trows):
            np.testing.assert_allclose(
                [float(v) for v in tv.split(",")],
                [float(v) for v in jv.split(",")], rtol=1e-5, atol=1e-6,
                err_msg=k)
    # every other batch: the interval of 2 collects batches 1 and 3
    assert [bool(r[1]) for r in got] == [True, False, True]
    names = [k for _, k, _ in got[0][1]]
    if pattern == ".*":
        assert "softmax_output" in names and "grad_fc1_weight" in names
    else:
        assert names == sorted(names) and all(
            k.startswith(("fc1", "grad_fc1")) for k in names)


def test_module_fit_prints_the_monitor(capsys):
    rng = np.random.RandomState(7)
    x = rng.randn(16, 5).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    with tmx.cpu():
        train = tmx.io.NDArrayIter(x, y, batch_size=8)
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        mon = monitor.Monitor(1, pattern="fc2.*")
        mod.fit(train, num_epoch=1, optimizer="sgd", monitor=mon,
                optimizer_params={"learning_rate": 0.1})
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("Batch:")]
    assert len(lines) == 2 * 4          # 2 batches x (out, w, b, grad_w..)
    assert any("grad_fc2_weight" in line for line in lines)


def _jax_host_events():
    """The JAX dump's host events, built by its own recorder: a task, an
    operator, a marker and a counter (its session itself is not run)."""
    was = dict(jprof._running)
    jprof._running["on"] = True
    try:
        t0 = time.perf_counter()
        jprof._record_event("tk", t0, t0 + 1e-3, cat="task")
        jprof.record_op("dot", t0, t0 + 1e-4)
        jprof.Marker(name="mk").mark()
        c = jprof.Counter(name="ctr")
        c.increment(3)
        events = list(jprof._events) + jprof._counter_events(clear=True)
    finally:
        jprof._running.clear()
        jprof._running.update(was)
        jprof._events.clear()
        jprof._aggregate.clear()
    return {(e["name"], e["ph"]): e for e in events}


def test_dump_is_one_trace_in_the_jax_schema(tmp_path):
    profiler.set_config(filename=str(tmp_path / "prof"))
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=5)
        net.initialize()
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        x = torch.ones(4, 5)
        profiler.set_state("run")
        c = profiler.Counter(name="ctr")
        c.increment(3)
        with profiler.Task(name="tk"):
            a = tmx.nd.ones((8, 8))
            tmx.nd.dot(a, a).wait_to_read()
        profiler.Marker(name="mk").mark()
        with tmx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(4)
        path = profiler.dump()
    trace = json.load(open(path))
    events = trace["traceEvents"]
    meta = [e for e in events if e.get("ph") == "M"
            and e.get("name") == "process_name"]
    assert meta and meta[0]["args"]["name"] == "mxnet_tpu_torch host"
    ours = {(e["name"], e["ph"]): e for e in events
            if e.get("cat") in ("task", "operator", "marker", "counter")}
    ref = _jax_host_events()
    for key in (("tk", "X"), ("dot", "X"), ("mk", "X"), ("ctr", "C")):
        assert key in ours, key
        assert set(ours[key]) == set(ref[key]), key
        assert ours[key]["cat"] == ref[key]["cat"], key
    assert ours[("ctr", "C")]["args"] == {"value": 3}
    # torch's events of the same session: the trainer's phases as spans
    # (torch's record_function ranges) and the host's ATen calls
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("step/step") for n in names)
    assert any(n.startswith("step/numerics") for n in names)
    assert any(n.startswith("aten::") for n in names)
    # the host events sit on torch's clock, within the session
    anchor = next(e for e in events if e.get("name") == "mx.profiler.start")
    assert ours[("tk", "X")]["ts"] >= anchor["ts"] - 1e3
    table = profiler.dumps(reset=True)
    assert table.splitlines()[0] == \
        "%-40s %10s %12s %12s" % ("Name", "Calls", "Total(ms)", "Avg(ms)")
    assert "dot" in table and "dot" not in profiler.dumps()


def test_a_running_torch_session_is_refused(tmp_path):
    profiler.set_config(filename=str(tmp_path / "prof2"))
    with torch.profiler.profile():
        with pytest.raises(MXNetError, match="already recording"):
            profiler.set_state("run")
    assert not profiler._active()
    profiler.start()
    profiler.start()                  # idempotent while ours runs
    profiler.stop()
    assert os.path.exists(profiler.dump())


def test_scopes_and_markers_while_off():
    with profiler.Frame(name="f"):
        pass
    ev = profiler.Event(name="e")
    ev.start()
    ev.stop()
    profiler.Marker(name="m").mark()
    c = profiler.Counter(name="c")
    c.increment()
    c.decrement()
    c.set_value(5)
    assert c.value == 5 and not c._samples
    assert "f" in profiler.dumps(reset=True)
