"""The port's `DynamicBatcher` and serving health plane against the JAX
package's, on the CPU (`mxnet_tpu_torch.serving.{batcher,health}`).

Both batchers take the same submissions (request sizes, deadlines,
policies) and must form the same batches — the same request sizes in
the same order — shed the same requests, and raise the same error
types; the health plane's env readers read the same values, and its
guard fires the same chaos sites. These are host code, so every
comparison is exact. Chaos specs are armed per test and disarmed after.
"""
import threading
import time

import numpy as np
import jax
from jax._src import compilation_cache
import pytest

from mxnet_tpu.resilience import Deadline as JaxDeadline
from mxnet_tpu.serving import batcher as jbatcher
from mxnet_tpu.serving import health as jhealth
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import DeviceUnreachable
from mxnet_tpu_torch.observability import registry as obs
from mxnet_tpu_torch.resilience import (Deadline, DeadlineExceeded,
                                        InjectedFault, chaos)
from mxnet_tpu_torch.serving import batcher as tbatcher
from mxnet_tpu_torch.serving import health as thealth

NF = 3


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
def _disarmed():
    chaos.configure("")
    yield
    chaos.reset()


PACKAGES = {"jax": (jbatcher, JaxDeadline), "port": (tbatcher, Deadline)}


def _run(pkg, script, **kw):
    """Feed `script` — a list of (rows, deadline_s or None) submissions,
    or "pop" — to one package's batcher; returns its batches as lists of
    row counts, the outcome of each submission and the shed count."""
    mod, deadline_cls = PACKAGES[pkg]
    b = mod.DynamicBatcher(["data"], **kw)
    handles, batches = [], []
    for item in script:
        if item == "pop":
            batch = b.next_batch(timeout=0.5)
            batches.append(None if batch is None else [r.n for r in batch])
            for r in batch or ():
                r.resolve([np.zeros((r.n, 1))])
            continue
        rows, dl = item
        try:
            handles.append(b.submit(
                np.zeros((rows, NF), np.float32),
                deadline=None if dl is None else deadline_cls(dl)))
        except Exception as err:  # noqa: BLE001 — compared by type
            handles.append(type(err).__name__)
        if dl == 0.0:
            time.sleep(0.01)
    outcome = []
    for h in handles:
        if isinstance(h, str):
            outcome.append(h)
        elif not h.done():
            outcome.append("queued")
        else:
            try:
                h.result(0)
                outcome.append("served")
            except Exception as err:  # noqa: BLE001 — compared by type
                outcome.append(type(err).__name__)
    return batches, outcome, b.shed


SCRIPTS = {
    "coalesce": ([(1, None)] * 4 + ["pop"],
                 dict(max_batch_size=8, max_wait_ms=50, queue_depth=16)),
    "split_at_max": ([(3, None)] * 3 + ["pop", "pop"],
                     dict(max_batch_size=4, max_wait_ms=1, queue_depth=16)),
    "fill_exactly": ([(2, None), (1, None), (1, None), (3, None), "pop",
                      "pop"],
                     dict(max_batch_size=4, max_wait_ms=1, queue_depth=16)),
    "deadline": ([(1, 0.0), (2, None), (1, 0.0), (1, 30.0), "pop"],
                 dict(max_batch_size=8, max_wait_ms=1, queue_depth=16)),
    "reject_when_full": ([(1, None)] * 3 + ["pop"],
                         dict(max_batch_size=4, max_wait_ms=1,
                              queue_depth=2, shed_policy="reject")),
    "drop_oldest": ([(1, None)] * 3 + ["pop"],
                    dict(max_batch_size=4, max_wait_ms=1, queue_depth=2,
                         shed_policy="drop_oldest")),
    "oversized": ([(5, None), (4, None), "pop"],
                  dict(max_batch_size=4, max_wait_ms=1, queue_depth=8)),
    "empty": (["pop"], dict(max_batch_size=4, max_wait_ms=1,
                            queue_depth=8)),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_batches_and_shedding_match_jax(case):
    script, kw = SCRIPTS[case]
    port = _run("port", script, **kw)
    jax_ = _run("jax", script, **kw)
    assert port == jax_, (port, jax_)


def test_deadline_rejection_is_typed_and_counted():
    b = tbatcher.DynamicBatcher(["data"], max_batch_size=8, max_wait_ms=1,
                                queue_depth=16)
    before = obs.REGISTRY.get("serving.shed.count").get(reason="deadline")
    doomed = b.submit(np.zeros((1, NF), np.float32), deadline=Deadline(0.0))
    live = b.submit(np.zeros((1, NF), np.float32))
    time.sleep(0.01)
    assert b.next_batch(timeout=1.0) == [live]
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=1.0)
    assert obs.REGISTRY.get("serving.shed.count").get(
        reason="deadline") == before + 1
    # a survivor whose deadline ran out in a worker backlog
    late = b.submit(np.zeros((1, NF), np.float32), deadline=Deadline(0.02))
    popped = b.next_batch(timeout=1.0)
    time.sleep(0.03)
    assert b.reject_expired(popped) == [] and late.done()


def test_closed_batcher_drains_then_ends():
    b = tbatcher.DynamicBatcher(["data"], max_batch_size=4, max_wait_ms=1,
                                queue_depth=8, name="m")
    queued = b.submit(np.zeros((1, NF), np.float32))
    b.close()
    with pytest.raises(tbatcher.ServerClosed) as err:
        b.submit(np.zeros((1, NF), np.float32))
    assert err.value.server == "m"
    assert b.next_batch(timeout=1.0) == [queued]
    assert b.next_batch(timeout=0.05) is None
    hard = tbatcher.DynamicBatcher(["data"], max_batch_size=4)
    waiting = hard.submit(np.zeros((1, NF), np.float32))
    hard.close(reject_queued=True)
    with pytest.raises(tbatcher.ServerClosed):
        waiting.result(0)


def test_wait_window_releases_a_partial_batch():
    b = tbatcher.DynamicBatcher(["data"], max_batch_size=64, max_wait_ms=30)
    t0 = time.perf_counter()
    b.submit(np.zeros((1, NF), np.float32))
    assert len(b.next_batch(timeout=5.0)) == 1
    assert time.perf_counter() - t0 < 2.0


def test_normalize_inputs_matches_jax():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for args in ((x, ["data"]), ({"a": x, "b": x[:, :1]}, ["a", "b"])):
        got, n = tbatcher._normalize_inputs(*args)
        ref, jn = jbatcher._normalize_inputs(*args)
        assert n == jn and sorted(got) == sorted(ref)
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k])
    for bad in (({"a": x, "b": x[:1]}, ["a", "b"]), (x, ["a", "b"]),
                (np.float32(1), ["data"]), ({"a": x}, ["a", "b"])):
        with pytest.raises(MXNetError):
            tbatcher._normalize_inputs(*bad)
        with pytest.raises(Exception):
            jbatcher._normalize_inputs(*bad)


def test_env_knobs_match_jax(monkeypatch):
    for k, v in (("MXTPU_SERVE_MAX_BATCH", "7"),
                 ("MXTPU_SERVE_MAX_WAIT_MS", "2.5"),
                 ("MXTPU_SERVE_QUEUE_DEPTH", "9"),
                 ("MXTPU_SERVE_SHED_POLICY", "drop_oldest")):
        monkeypatch.setenv(k, v)
    t = tbatcher.DynamicBatcher(["data"])
    j = jbatcher.DynamicBatcher(["data"])
    assert (t.max_batch_size, t.max_wait_s, t.queue_depth, t.shed_policy) \
        == (j.max_batch_size, j.max_wait_s, j.queue_depth, j.shed_policy)
    with pytest.raises(MXNetError):
        tbatcher.DynamicBatcher(["data"], shed_policy="lifo")


# -- the health plane -------------------------------------------------------
READERS = ("dispatch_timeout", "trip_limit", "canary_interval",
           "breaker_fails", "breaker_cooldown", "hedge_delay_ms")


@pytest.mark.parametrize("env", [
    {},
    {"MXTPU_SERVE_DISPATCH_TIMEOUT_S": "0.5", "MXTPU_SERVE_TRIP_LIMIT": "0",
     "MXTPU_SERVE_CANARY_S": "0.01", "MXTPU_BREAKER_FAILS": "2",
     "MXTPU_BREAKER_COOLDOWN_S": "0.01", "MXTPU_GATEWAY_HEDGE_MS": "auto"},
    {"MXTPU_GATEWAY_HEDGE_MS": "12.5", "MXTPU_SERVE_TRIP_LIMIT": "5"},
])
def test_env_readers_match_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for name in READERS:
        assert getattr(thealth, name)() == getattr(jhealth, name)(), name
    assert thealth.replica_site(3) == jhealth.replica_site(3)
    assert thealth.REPLICA_STATES == jhealth.REPLICA_STATES
    assert thealth.BREAKER_STATES == jhealth.BREAKER_STATES


def test_guard_is_the_direct_call_when_off():
    thread = []
    assert thealth.guard(thealth.HealthWatchdog(), lambda: thread.append(
        threading.current_thread()) or 4, "x") == 4
    assert thread == [threading.current_thread()]


def test_guard_fires_every_chaos_site_inside_the_dispatch():
    chaos.configure("serving.replica2.dispatch:p=1,kind=raise,n=1")
    sites = ("engine.dispatch", thealth.replica_site(2))
    with pytest.raises(InjectedFault):
        thealth.guard(None, lambda: 1, "x", sites=sites)
    assert thealth.guard(None, lambda: 1, "x", sites=sites) == 1
    assert chaos.trip_count("serving.replica2.dispatch") == 1


def test_guard_trip_is_typed_when_armed(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_DISPATCH_TIMEOUT_S", "0.2")
    chaos.configure("engine.dispatch:p=1,kind=hang,secs=2,n=1")
    with pytest.raises(DeviceUnreachable, match="wedged"):
        thealth.guard(thealth.HealthWatchdog(), lambda: 1, "wedge probe")


def test_replica_and_breaker_state_surfaces(capsys):
    thealth.set_replica_state("srv", 1, "quarantined", reason="watchdog")
    assert thealth.REPLICA_STATE.get(server="srv", replica="1") == 1
    thealth.set_breaker_state("mdl", "open", reason="X")
    assert thealth.BREAKER_STATE.get(model="mdl") == 2
    err = capsys.readouterr().err
    assert "MXTPU_SERVE replica_state reason=watchdog replica=1 " \
        "server=srv state=quarantined" in err
    assert "MXTPU_SERVE breaker_state model=mdl reason=X state=open" in err


def test_typed_errors_keep_jaxs_shape():
    e = thealth.NoHealthyReplica("x", server="s", recovering=1)
    assert (e.server, e.recovering) == ("s", True)
    assert issubclass(thealth.SchedulerCrashed, tbatcher.ServerClosed)
    assert issubclass(thealth.BreakerOpen, tbatcher.RequestRejected)
    b = thealth.BreakerOpen("y", model="m", retry_after_s=1.5)
    assert (b.model, b.retry_after_s) == ("m", 1.5)
    assert thealth.DeviceUnreachable is DeviceUnreachable
