"""The port's preemption boundary and gang supervision
(mxnet_tpu_torch/resilience/{preempt,supervisor}.py, the peer check of
parallel/kvstore_dist.py and tools/torch_launch.py) on the CPU.

In one process, against the JAX package's: a `PreemptionGuard` turns
SIGTERM into a save and `TrainingPreempted` (75) at the next boundary,
cooperatively without raising, and a second signal into
`KeyboardInterrupt`; a rank heartbeat holds the JAX record's keys; a dead
pid or a silent heartbeat is a dead peer; `peer_checker` raises
`PeerLost` (76); a collective's wait gives up on a dead peer.

Gangs of tests/torch_gang_worker.py (an MLP through `gluon.Trainer` over
gloo, a checkpoint a step) through ``tools/torch_launch.py
--supervise``, each with a time limit of its own:

- a rank killed mid-run by ``MXTPU_CHAOS_RANK_1``: the survivor exits 76,
  the gang restarts once without the rank chaos and ends bit-identical
  to an uninterrupted gang;
- every rank preempted: the gang stops with 75 and no restart, and a
  relaunch resumes bit-identical;
- a wedged rank (stopped, its heartbeat silent) is found by heartbeat
  age and named as the incident's rank;
- heartbeats of an earlier run in the gang dir are cleared;
- three supervised gangs started at once all rendezvous (rank 0 binds
  the coordinator's port and publishes it; nothing is probed);
- a NaN injected at ``grad.post`` for ``MXTPU_DIVERGE_PATIENCE`` steps
  rolls the checkpoints back and exits 77; the relaunch ends
  bit-identical to a clean run.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
from jax._src import compilation_cache
import pytest

from mxnet_tpu.resilience import preempt as jpreempt
from mxnet_tpu.resilience import supervisor as jsup
from mxnet_tpu_torch.parallel import kvstore_dist
from mxnet_tpu_torch.resilience import preempt, supervisor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_gang_worker.py")
LAUNCH = os.path.join(ROOT, "tools", "torch_launch.py")
GANG_TIMEOUT_S = 120
STEPS = 6


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


# -- in one process -----------------------------------------------------------
@pytest.mark.parametrize("pkg", [preempt, jpreempt], ids=["port", "jax"])
def test_sigterm_saves_at_the_boundary_and_raises_75(pkg):
    saved = []
    before = signal.getsignal(signal.SIGTERM)
    with pkg.PreemptionGuard(save=lambda: saved.append(1) or 7) as guard:
        pkg.at_step_boundary()                   # nothing pending
        os.kill(os.getpid(), signal.SIGTERM)
        assert pkg.preemption_requested()
        with pytest.raises(pkg.TrainingPreempted) as err:
            pkg.at_step_boundary()
    assert (err.value.step, err.value.exit_code, saved) == (7, 75, [1])
    assert guard.preempted and guard.saved_step == 7
    assert not pkg.preemption_requested()
    assert signal.getsignal(signal.SIGTERM) == before    # restored


@pytest.mark.parametrize("pkg", [preempt, jpreempt], ids=["port", "jax"])
def test_cooperative_guard_and_second_signal(pkg):
    with pkg.PreemptionGuard(reraise=False) as guard:
        os.kill(os.getpid(), signal.SIGINT)
        pkg.at_step_boundary()
        assert guard.preempted and guard.saved_step is None
        os.kill(os.getpid(), signal.SIGINT)
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)     # still pending
        pkg.at_step_boundary()


def test_heartbeat_record_and_dead_peers_match_jax(tmp_path):
    port_dir, jax_dir = tmp_path / "p", tmp_path / "j"
    supervisor.RankHeartbeat(0, str(port_dir)).beat(step=3)
    jsup.RankHeartbeat(0, str(jax_dir)).beat(step=3)
    prec = supervisor.read_heartbeat(str(port_dir / "rank_0.hb"))
    jrec = jsup.read_heartbeat(str(jax_dir / "rank_0.hb"))
    assert set(prec) == set(jrec) and prec["step"] == 3
    assert prec["pid"] == os.getpid()
    # a finished process's record: provably dead, whatever its age
    gone = subprocess.Popen([sys.executable, "-c", "pass"])
    gone.wait()
    for d in (port_dir, jax_dir):
        with open(d / "rank_1.hb", "w") as f:
            json.dump(dict(prec, rank=1, pid=gone.pid), f)
        with open(d / "rank_2.hb", "w") as f:
            json.dump(dict(prec, rank=2, heartbeat=time.time() - 60), f)
    for d, pkg in ((port_dir, supervisor), (jax_dir, jsup)):
        dead = pkg.dead_peers(str(d), exclude_rank=0, timeout_s=15)
        assert [r for r, _ in dead] == [1, 2]
        assert "is gone" in dead[0][1] and "silent" in dead[1][1]
        assert [s["rank"] for s in pkg.peer_status(str(d))] == [0, 1, 2]
        check = pkg.peer_checker(exclude_rank=0, directory=str(d))
        with pytest.raises(pkg.PeerLost) as err:
            check()
        assert err.value.rank == 1 and err.value.exit_code == 76


def test_a_waiting_collective_raises_peer_lost():
    class Never:
        def is_completed(self):
            return False

        def wait(self):
            raise AssertionError("never done")

    calls = []

    def check():
        calls.append(1)
        if len(calls) >= 2:
            raise supervisor.PeerLost("rank 1 is gone", rank=1)

    t0 = time.monotonic()
    with pytest.raises(supervisor.PeerLost):
        kvstore_dist.wait_bounded(Never(), 0.0, "allreduce", check)
    assert time.monotonic() - t0 < 5
    # an error of the collective while a peer is dead is the dead peer

    class Broken:
        def is_completed(self):
            return True

        def wait(self):
            raise RuntimeError("Connection closed by peer")

    with pytest.raises(supervisor.PeerLost) as err:
        kvstore_dist.wait_bounded(Broken(), 0.0, "allreduce",
                                  lambda: check())
    assert isinstance(err.value.__cause__, RuntimeError)
    with pytest.raises(RuntimeError):
        kvstore_dist.wait_bounded(Broken(), 0.0, "allreduce", lambda: None)


def test_adopt_checks_the_gang_size(tmp_path):
    sup = supervisor.GangSupervisor(["true"], 2, gang_dir=str(tmp_path))
    with pytest.raises(supervisor.MXNetError):
        sup.adopt([object()])
    assert sup.report() == {"nranks": 2, "generation": 0, "restarts": 0,
                            "gang_dir": str(tmp_path), "incidents": []}


# -- gangs through tools/torch_launch.py --supervise --------------------------
def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_CHAOS", "MXTPU_GANG", "JAX_",
                                "DMLC_", "MXTPU_TELEMETRY"))}
    env.update(PYTHONPATH=ROOT, MXTPU_RESTART_BACKOFF_S="0.1",
               MXTPU_GANG_KILL_GRACE_S="2", MXTPU_GANG_PEER_POLL_S="0.2",
               MXTPU_BARRIER_TIMEOUT_S="60", MXTPU_WATCHDOG_INIT_S="60",
               MXTPU_DIST_INIT_TIMEOUT_S="60")
    env.update(extra)
    return env


def _start(d, n, env, *worker_args, steps=STEPS):
    cmd = [sys.executable, LAUNCH, "-n", str(n), "--supervise",
           "--gang-dir", os.path.join(d, "gang"), sys.executable, WORKER,
           "--steps", str(steps), "--ckpt-dir", os.path.join(d, "ck"),
           "--out", os.path.join(d, "o"), *worker_args]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT,
                            start_new_session=True)


def _finish(proc, timeout=GANG_TIMEOUT_S):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("the gang outlived its %d s" % timeout)
    log = out.decode(errors="replace")
    report = [json.loads(line.split(" ", 1)[1]) for line in
              log.splitlines() if line.startswith("GANG_REPORT ")]
    return proc.returncode, log, (report[-1] if report else None)


def _gang(d, n, env, *worker_args, steps=STEPS):
    return _finish(_start(d, n, env, *worker_args, steps=steps))


def _events(d, rank):
    path = os.path.join(d, "o.r%d.jsonl" % rank)
    if not os.path.exists(path):
        return []
    return [json.loads(line) for line in open(path)]


def _done(d, rank):
    return [e for e in _events(d, rank) if e["event"] == "done"]


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """The digests of uninterrupted gangs of 2 ranks and of 1."""
    out = {}
    for n in (2, 1):
        d = str(tmp_path_factory.mktemp("clean%d" % n))
        rc, log, report = _gang(d, n, _env())
        assert rc == 0 and report["restarts"] == 0, log[-3000:]
        digests = {e["digest"] for r in range(n) for e in _done(d, r)}
        assert len(digests) == 1, digests       # every rank, the same bits
        out[n] = digests.pop()
    return out


def test_killed_rank_restarts_the_gang_bit_identically(tmp_path, clean):
    d = str(tmp_path)
    rc, log, report = _gang(d, 2, _env(
        MXTPU_CHAOS_RANK_1="worker.kill:kind=kill,after=5"))
    assert rc == 0, log[-4000:]
    assert report["restarts"] == 1 and report["generation"] == 1
    [inc] = report["incidents"]
    assert (inc["rank"], inc["exit_code"], inc["action"]) == (1, -9,
                                                              "restart")
    assert inc["rank_exit_codes"]["0"] == 76          # PeerLost
    assert "PeerLost" in log or "gang peer rank 1 is lost" in log
    starts = [e for e in _events(d, 1) if e["event"] == "start"]
    # the rank chaos armed generation 0 only
    assert [(s["generation"], s["rank_chaos"]) for s in starts] == \
        [(0, ["MXTPU_CHAOS_RANK_1"]), (1, [])]
    assert starts[1]["restored_step"] == 2
    assert {e["digest"] for r in (0, 1) for e in _done(d, r)} == \
        {clean[2]}
    with open(os.path.join(d, "gang", "report.json")) as f:
        assert json.load(f)["restarts"] == 1


def test_preempted_gang_stops_and_resumes_bit_identically(tmp_path, clean):
    d = str(tmp_path)
    rc, log, report = _gang(d, 2, _env(), "--sigterm-at", "2")
    assert rc == 75, log[-4000:]
    assert report["restarts"] == 0
    assert report["incidents"][0]["action"] == "stop (preempted)"
    assert not _done(d, 0)
    rc, log, report = _gang(d, 2, _env())
    assert rc == 0, log[-4000:]
    starts = [e for e in _events(d, 0) if e["event"] == "start"]
    assert starts[-1]["restored_step"] == 2
    assert {e["digest"] for r in (0, 1) for e in _done(d, r)} == \
        {clean[2]}


def test_wedged_rank_is_found_by_heartbeat_age(tmp_path, clean):
    d = str(tmp_path)
    proc = _start(d, 2, _env(MXTPU_GANG_PEER_TIMEOUT_S="4",
                             MXTPU_GANG_HEARTBEAT_S="0.25"),
                  "--pause", "0.5")
    stopped = []

    def wedge():
        deadline = time.monotonic() + GANG_TIMEOUT_S
        while time.monotonic() < deadline and not stopped:
            if any(e["event"] == "step" and e["step"] >= 2
                   for e in _events(d, 1)):
                hb = supervisor.read_heartbeat(
                    os.path.join(d, "gang", "rank_1.hb"))
                os.kill(hb["pid"], signal.SIGSTOP)
                stopped.append(hb["pid"])
                return
            time.sleep(0.05)
    th = threading.Thread(target=wedge, daemon=True)
    th.start()
    rc, log, report = _finish(proc)
    th.join(5)
    assert stopped and rc == 0, log[-4000:]
    assert report["restarts"] == 1
    [inc] = report["incidents"]
    assert inc["rank"] == 1 and inc["wedged"], inc
    assert inc["rank_exit_codes"]["0"] == 76
    assert "heartbeat silent" in log
    assert {e["digest"] for r in (0, 1) for e in _done(d, r)} == \
        {clean[2]}


def test_stale_heartbeats_are_cleared(tmp_path, clean):
    d = str(tmp_path)
    gone = subprocess.Popen([sys.executable, "-c", "pass"])
    gone.wait()
    os.makedirs(os.path.join(d, "gang"))
    for r in (0, 1):
        with open(os.path.join(d, "gang", "rank_%d.hb" % r), "w") as f:
            json.dump({"rank": r, "pid": gone.pid, "heartbeat": 0.0,
                       "created": 0.0}, f)
    with open(os.path.join(d, "gang", "port.0"), "w") as f:
        f.write("1")                     # an earlier run's port file
    rc, log, report = _gang(d, 2, _env())
    assert rc == 0 and report["restarts"] == 0, log[-4000:]
    assert {e["digest"] for r in (0, 1) for e in _done(d, r)} == \
        {clean[2]}


def test_three_gangs_started_at_once_all_rendezvous(tmp_path, clean):
    dirs = [str(tmp_path / ("g%d" % i)) for i in range(3)]
    procs = [_start(d, 2, _env()) for d in dirs]
    for d, p in zip(dirs, procs):
        rc, log, report = _finish(p)
        assert rc == 0 and report["restarts"] == 0, log[-3000:]
        assert {e["digest"] for r in (0, 1) for e in _done(d, r)} == \
            {clean[2]}


def test_divergence_rolls_back_and_the_relaunch_ends_clean(tmp_path,
                                                           clean):
    d = str(tmp_path)
    rc, log, report = _gang(d, 1, _env(
        MXTPU_DIVERGE_PATIENCE="2",
        MXTPU_CHAOS_RANK_0="grad.post:kind=nan,after=3,n=2"))
    assert rc == 0, log[-4000:]
    assert report["restarts"] == 1
    [inc] = report["incidents"]
    assert (inc["exit_code"], inc["action"]) == (77,
                                                 "restart (rolled back)")
    assert "MXTPU_NUMERICS rollback step=4 restored_step=1" in log
    starts = [e for e in _events(d, 0) if e["event"] == "start"]
    assert [s["restored_step"] for s in starts] == [None, 1]
    assert [e["digest"] for e in _done(d, 0)] == [clean[1]]
