"""Elastic gang supervision: peer-failure detection and coordinated
restart for distributed training (counterpart of
mxnet_tpu/resilience/supervisor.py).

* **`RankHeartbeat`**: each rank of a gang writes
  ``<gang_dir>/rank_<r>.hb``, refreshed by a daemon thread through
  `resilience.atomic.atomic_write`, carrying the identity record the
  device lease uses (pid, boot id, /proc starttime; `resilience.lease`).
  A reader proves a peer dead the moment its pid is gone, without a
  timeout.
* **`PeerLost`** (exit 76): what a survivor raises instead of waiting
  out a collective. `parallel.kvstore_dist` polls `peer_checker()` while
  its collectives and barriers wait, so a killed peer is found in
  seconds.
* **`GangSupervisor`**: spawns (or `adopt`s) the N-rank gang, watches
  each rank, tears the stragglers down when one dies (they would only
  hang in the next collective) and relaunches the gang, bounded
  (``MXTPU_MAX_RESTARTS``) with exponential backoff
  (``MXTPU_RESTART_BACKOFF_S``); the ranks resume from their latest
  committed checkpoint. Restarts and downtime go to the registry, the
  telemetry stream and `report()` (``<gang_dir>/report.json``).

The rendezvous of a generation. The JAX package's supervisor probes a
free port, closes it and hands it to the ranks; another process can take
it in between. Here every generation gets a coordinator of port 0 and a
port file of its own (``<gang_dir>/port.<generation>``, through
``MXTPU_DIST_PORT_FILE``): rank 0 binds a port itself and publishes it
there (`parallel.kvstore_dist.init_distributed`), so nothing is probed.

Exit-code contract (restart or stop without parsing stderr):

  ==============  ====  =====================================
  outcome         code  supervisor decision
  ==============  ====  =====================================
  clean finish       0  gang done; no restart
  preempted         75  external eviction: stop
  peer lost         76  a survivor's collateral, never the cause
  diverged          77  the worker rolled back already: restart
  anything else    any  crash: teardown + restart (bounded)
  ==============  ====  =====================================

`run_supervised(fn)` is the worker's side: it maps the typed exceptions
onto these codes.

Env knobs (as the JAX package's):
  MXTPU_GANG_DIR           gang state dir (set by the supervisor for
                           its children; its presence = supervised)
  MXTPU_GANG_HEARTBEAT_S   rank heartbeat refresh interval (1.0)
  MXTPU_GANG_PEER_TIMEOUT_S  heartbeat age past which a live-pid peer
                           counts as wedged-dead (15)
  MXTPU_GANG_PEER_POLL_S   how often a waiting collective checks (0.5)
  MXTPU_MAX_RESTARTS       gang relaunches before giving up (3)
  MXTPU_RESTART_BACKOFF_S  first restart backoff, doubled per
                           incident, capped at 60 (1.0)
  MXTPU_GANG_KILL_GRACE_S  straggler SIGTERM->SIGKILL grace (10)
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from ..base import MXNetError, getenv
from ..observability import registry as _obs
from ..observability import telemetry as _tele
from .atomic import atomic_write
from .lease import _boot_id, _heartbeat_age, _holder_alive, _proc_starttime
from .numerics import EXIT_DIVERGED, TrainingDiverged
from .preempt import TrainingPreempted

__all__ = ["EXIT_DIVERGED", "EXIT_PEER_LOST", "EXIT_PREEMPTED",
           "GangSupervisor", "PeerLost", "RankHeartbeat", "dead_peers",
           "ensure_rank_heartbeat", "exit_status", "gang_dir",
           "peer_checker", "peer_status", "read_heartbeat",
           "run_supervised", "stop_rank_heartbeat"]

EXIT_PREEMPTED = TrainingPreempted.exit_code   # 75
EXIT_PEER_LOST = 76

RESTARTS = _obs.counter(
    "resilience.supervisor.restarts",
    "Gang relaunches performed by a GangSupervisor")
DOWNTIME = _obs.histogram(
    "resilience.supervisor.downtime.seconds",
    "Per-incident downtime: first rank-failure detection to the gang "
    "running again")
HB_AGE = _obs.gauge(
    "resilience.supervisor.rank.heartbeat.age",
    "Last observed per-rank heartbeat age in seconds (label rank)")

_log = logging.getLogger("mxnet_tpu_torch.resilience")


class PeerLost(MXNetError):
    """A gang peer is provably dead (pid gone or recycled, another boot)
    or silent past the heartbeat timeout while this rank waited in a
    collective. `.rank` names it."""

    exit_code = EXIT_PEER_LOST

    def __init__(self, msg, rank=None):
        super().__init__(msg)
        self.rank = rank


# -- gang identity -------------------------------------------------------
def gang_dir():
    """The gang state directory (``MXTPU_GANG_DIR``), or None outside a
    supervised gang."""
    return os.environ.get("MXTPU_GANG_DIR") or None


def _hb_path(directory, rank):
    return os.path.join(directory, "rank_%d.hb" % int(rank))


def _supervisor_path(directory):
    return os.path.join(directory, "supervisor.json")


def _port_path(directory, generation):
    return os.path.join(directory, "port.%d" % int(generation))


def read_heartbeat(path):
    """The heartbeat record at `path`, or None (absent or torn)."""
    try:
        with open(path) as f:
            rec = json.loads(f.read())
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


class RankHeartbeat:
    """One rank's liveness beacon: a JSON identity record rewritten every
    ``MXTPU_GANG_HEARTBEAT_S`` seconds by a daemon thread."""

    def __init__(self, rank, directory=None, interval_s=None):
        self.rank = int(rank)
        self.directory = directory or gang_dir()
        if self.directory is None:
            raise MXNetError("RankHeartbeat needs a gang directory "
                             "(MXTPU_GANG_DIR unset)")
        self.interval_s = float(
            interval_s if interval_s is not None
            else getenv("MXTPU_GANG_HEARTBEAT_S", 1.0))
        self.path = _hb_path(self.directory, self.rank)
        self.step = None
        self._created = None
        self._stop = threading.Event()
        self._thread = None

    def _record(self):
        pid = os.getpid()
        if self._created is None:
            self._created = time.time()
        rec = {"rank": self.rank, "pid": pid,
               "host": socket.gethostname(), "boot_id": _boot_id(),
               "starttime": _proc_starttime(pid),
               "created": self._created, "heartbeat": time.time(),
               "interval_s": self.interval_s}
        if self.step is not None:
            rec["step"] = int(self.step)
        return rec

    def beat(self, step=None):
        """One heartbeat write (also callable from a loop, to carry the
        step)."""
        if step is not None:
            self.step = int(step)
        try:
            os.makedirs(self.directory, exist_ok=True)
            with atomic_write(self.path, "w") as f:
                f.write(json.dumps(self._record(), sort_keys=True))
        except OSError:
            return False
        return True

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self.beat()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="gang-heartbeat:r%d" % self.rank)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self, unlink=False):
        self._stop.set()
        th = self._thread
        if th is not None and th is not threading.current_thread():
            th.join(timeout=2.0 * self.interval_s + 1.0)
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


_process_hb = {"hb": None, "atexit": False, "crashed": False}
_process_hb_lock = threading.Lock()


def stop_rank_heartbeat(unlink=True):
    """Stop the process's rank heartbeat; with `unlink` its file goes
    too, telling peers this rank left cleanly (a finished rank's record
    with a dead pid would read as a lost peer). Runs at exit; a killed
    or crashed rank leaves its record, the evidence its peers need."""
    with _process_hb_lock:
        hb, _process_hb["hb"] = _process_hb["hb"], None
    if hb is not None:
        hb.stop(unlink=unlink)


def ensure_rank_heartbeat(rank, directory=None):
    """Start (or reuse) the process's rank heartbeat; None outside a
    gang. `init_distributed` calls it once the rank is known."""
    directory = directory or gang_dir()
    if directory is None:
        return None
    with _process_hb_lock:
        hb = _process_hb["hb"]
        if hb is not None and hb.rank == int(rank) \
                and hb.directory == directory:
            return hb
        if hb is not None:
            hb.stop()
        hb = RankHeartbeat(rank, directory)
        hb.start()
        _process_hb["hb"] = hb
        if not _process_hb["atexit"]:
            # only a clean exit unlinks: an uncaught exception marks the
            # process crashed before atexit runs
            prev_hook = sys.excepthook

            def _mark_crashed(*exc_info):
                _process_hb["crashed"] = True
                return prev_hook(*exc_info)

            sys.excepthook = _mark_crashed
            atexit.register(lambda: stop_rank_heartbeat(
                unlink=not _process_hb["crashed"]))
            _process_hb["atexit"] = True
        return hb


# -- peer-failure detection ---------------------------------------------
def peer_status(directory=None, exclude_rank=None):
    """Every rank heartbeat in the gang dir: [{rank, age_s, alive, pid,
    step}], and the heartbeat-age gauge."""
    directory = directory or gang_dir()
    out = []
    if directory is None:
        return out
    try:
        entries = os.listdir(directory)
    except OSError:
        return out
    for name in sorted(entries):
        if not (name.startswith("rank_") and name.endswith(".hb")):
            continue
        try:
            rank = int(name[len("rank_"):-len(".hb")])
        except ValueError:
            continue
        if exclude_rank is not None and rank == int(exclude_rank):
            continue
        rec = read_heartbeat(os.path.join(directory, name))
        if rec is None:
            continue
        age = _heartbeat_age(rec)
        HB_AGE.set(age, rank=str(rank))
        out.append({"rank": rank, "age_s": age,
                    "alive": _holder_alive(rec), "pid": rec.get("pid"),
                    "step": rec.get("step")})
    return out


def dead_peers(directory=None, exclude_rank=None, timeout_s=None):
    """[(rank, reason)] of ranks provably dead (identity check failed) or
    wedged (live pid, heartbeat silent past
    ``MXTPU_GANG_PEER_TIMEOUT_S``)."""
    if timeout_s is None:
        timeout_s = getenv("MXTPU_GANG_PEER_TIMEOUT_S", 15.0)
    timeout_s = float(timeout_s)
    out = []
    for st in peer_status(directory, exclude_rank=exclude_rank):
        if not st["alive"]:
            out.append((st["rank"], "pid %s is gone (heartbeat %.1fs ago)"
                        % (st["pid"], st["age_s"])))
        elif st["age_s"] > timeout_s:
            out.append((st["rank"],
                        "heartbeat silent for %.1fs (timeout %.6gs, "
                        "pid %s still present)"
                        % (st["age_s"], timeout_s, st["pid"])))
    return out


def peer_checker(exclude_rank=None, directory=None, timeout_s=None,
                 what="collective"):
    """The callable a waiting collective polls: raises `PeerLost` naming
    the first dead rank (and emits a ``rank_lost`` event). None outside a
    gang, so call sites need no branch."""
    directory = directory or gang_dir()
    if directory is None:
        return None

    def check():
        dead = dead_peers(directory, exclude_rank=exclude_rank,
                          timeout_s=timeout_s)
        if not dead:
            return
        rank, reason = dead[0]
        _tele.emit({"ts": time.time(), "source": "resilience",
                    "event": "rank_lost", "rank": rank,
                    "reason": reason, "step_time": 0.0,
                    "observer_rank": exclude_rank})
        raise PeerLost(
            "gang peer rank %d is lost while this rank waited in a %s: "
            "%s — aborting instead of waiting out the collective's budget"
            % (rank, what, reason), rank=rank)

    return check


# -- the worker's side of the exit-code contract -------------------------
def exit_status(err):
    """The exit code for a training loop's exception: the typed errors'
    `.exit_code` (75, 76, 77), else 1."""
    return int(getattr(err, "exit_code", 1))


def run_supervised(fn):
    """Run `fn()` and map the typed resilience exceptions onto the gang's
    exit codes. On a clean return the rank heartbeat is unlinked first.
    `PeerLost` leaves through ``os._exit``: the dead collective still
    blocks a thread and the group cannot be torn down politely."""
    try:
        result = fn()
        stop_rank_heartbeat(unlink=True)
        return result
    except (TrainingPreempted, TrainingDiverged) as err:
        print("run_supervised: %s" % err, file=sys.stderr, flush=True)
        sys.exit(exit_status(err))
    except PeerLost as err:
        print("run_supervised: %s" % err, file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(exit_status(err))


# -- the supervisor ------------------------------------------------------
def _pump(prefix, stream, out):
    for line in iter(stream.readline, b""):
        out.write("%s%s" % (prefix, line.decode(errors="replace")))
        out.flush()


class GangSupervisor:
    """Spawn or adopt an N-rank gang, watch each rank and keep the gang
    running through rank failures (module note).

    `command` is each rank's argv. Every rank gets the rendezvous env of
    `tools/torch_launch.py` (``JAX_*``/``DMLC_*``, a coordinator of port
    0 and this generation's ``MXTPU_DIST_PORT_FILE``) plus
    ``MXTPU_GANG_DIR``, ``MXTPU_SUPERVISED=1`` and
    ``MXTPU_GANG_GENERATION``. `rank_env` maps a rank to extra env for
    generation 0 only, and ``MXTPU_CHAOS_RANK_*`` variables are stripped
    from every later generation: an injected incident happens once."""

    def __init__(self, command, nranks, gang_dir=None, base_env=None,
                 rank_env=None, max_restarts=None, backoff_s=None,
                 kill_grace_s=None, poll_s=0.25, out=None):
        self.command = list(command)
        self.nranks = int(nranks)
        self.dir = os.path.abspath(gang_dir) if gang_dir else \
            os.path.join(os.environ.get("TMPDIR", "/tmp"),
                         "mxtpu_gang_%d_%d" % (os.getuid(), os.getpid()))
        self.base_env = dict(base_env if base_env is not None
                             else os.environ)
        self.rank_env = {int(r): dict(e)
                         for r, e in (rank_env or {}).items()}
        self.max_restarts = int(
            max_restarts if max_restarts is not None
            else getenv("MXTPU_MAX_RESTARTS", 3))
        self.backoff_s = float(
            backoff_s if backoff_s is not None
            else getenv("MXTPU_RESTART_BACKOFF_S", 1.0))
        self.kill_grace_s = float(
            kill_grace_s if kill_grace_s is not None
            else getenv("MXTPU_GANG_KILL_GRACE_S", 10.0))
        self.poll_s = float(poll_s)
        self.out = out if out is not None else sys.stdout
        self.generation = 0
        self.restarts = 0
        self.incidents = []
        self.procs = []
        self._pumps = []
        self._created = None
        self._hb_stop = threading.Event()
        self._hb_thread = None

    # -- the supervisor's own identity record --------------------------
    def _write_record(self):
        pid = os.getpid()
        if self._created is None:
            self._created = time.time()
        rec = {"what": "gang-supervisor", "pid": pid,
               "host": socket.gethostname(), "boot_id": _boot_id(),
               "starttime": _proc_starttime(pid),
               "nranks": self.nranks, "generation": self.generation,
               "restarts": self.restarts, "created": self._created,
               "heartbeat": time.time(),
               "cmdline": " ".join(self.command)[:200]}
        try:
            with atomic_write(_supervisor_path(self.dir), "w") as f:
                f.write(json.dumps(rec, sort_keys=True))
        except OSError:
            pass

    def _heartbeat_loop(self):
        while not self._hb_stop.wait(1.0):
            self._write_record()

    def _ensure_heartbeat_thread(self):
        if self._hb_thread is None:
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="gang-supervisor-heartbeat")
            self._hb_thread.start()

    # -- spawning ------------------------------------------------------
    def _rank_environ(self, rank):
        env = dict(self.base_env)
        if self.generation > 0:
            for key in [k for k in env
                        if k.startswith("MXTPU_CHAOS_RANK_")]:
                env.pop(key)
        env.update(rendezvous_env(self.nranks, rank,
                                  _port_path(self.dir, self.generation)))
        env.update({
            "MXTPU_GANG_DIR": self.dir,
            "MXTPU_SUPERVISED": "1",
            "MXTPU_GANG_GENERATION": str(self.generation),
        })
        if self.generation == 0:
            env.update(self.rank_env.get(rank, {}))
        return env

    def _clear(self, names):
        for name in names:
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                pass

    def spawn(self):
        """Start one generation: its own port file, no rank heartbeats of
        an earlier one (they would read as dead peers at once), N
        children."""
        os.makedirs(self.dir, exist_ok=True)
        try:
            names = os.listdir(self.dir)
        except OSError:
            names = []
        self._clear([n for n in names
                     if (n.startswith("rank_") and n.endswith(".hb"))
                     or n.startswith("port.")])
        if self.generation == 0:
            # a reused gang dir: the trace shards of an earlier run would
            # merge into this run's per-step traces
            self._clear([n for n in names if n.startswith("trace_rank_")
                         and n.endswith(".jsonl")])
        self._write_record()
        self._ensure_heartbeat_thread()
        self.procs = []
        for rank in range(self.nranks):
            p = subprocess.Popen(
                self.command, env=self._rank_environ(rank),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            t = threading.Thread(
                target=_pump, args=("[%d] " % rank, p.stdout, self.out),
                daemon=True)
            t.start()
            self.procs.append(p)
            self._pumps.append(t)
        _log.info("gang generation %d: %d ranks spawned (port file %s, "
                  "gang dir %s)", self.generation, self.nranks,
                  _port_path(self.dir, self.generation), self.dir)
        return self.procs

    def adopt(self, procs):
        """Adopt a generation the caller spawned: watching, teardown and
        restarts apply; only the first spawn was the caller's."""
        if len(procs) != self.nranks:
            raise MXNetError("adopt() got %d processes for an %d-rank "
                             "gang" % (len(procs), self.nranks))
        os.makedirs(self.dir, exist_ok=True)
        self._write_record()
        self._ensure_heartbeat_thread()
        self.procs = list(procs)
        return self.procs

    # -- teardown ------------------------------------------------------
    def _teardown(self):
        """SIGTERM every running rank, wait the grace, SIGKILL. Returns
        {rank: returncode}."""
        alive = [p for p in self.procs if p.poll() is None]
        for p in alive:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + max(0.2, self.kill_grace_s)
        for p in alive:
            try:
                p.wait(timeout=max(0.05, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                except OSError:
                    pass
                p.wait()
        return {r: p.returncode for r, p in enumerate(self.procs)}

    # -- the supervision loop ------------------------------------------
    def run(self, procs=None):
        """Supervise until the gang finishes, is preempted or runs out of
        restarts. Returns the gang's exit code (0, 75 or the failing
        rank's code)."""
        if procs is not None:
            self.adopt(procs)
        elif not self.procs:
            self.spawn()
        try:
            return self._run_loop()
        finally:
            self._hb_stop.set()
            for t in self._pumps:
                t.join(timeout=2.0)
            self._write_report()

    def _root_cause(self, rank, rc):
        """For a survivor's 76: the rank the heartbeats name, preferring
        one still running (wedged) over one that exited with a collateral
        code. Returns (rank, rc, wedged)."""
        cands = []
        for drank, _reason in dead_peers(self.dir):
            if not (0 <= drank < self.nranks) or drank == rank:
                continue
            drc = self.procs[drank].poll()
            if drc in (EXIT_PEER_LOST, EXIT_PREEMPTED):
                continue
            cands.append((drank, drc))
        cands.sort(key=lambda c: (c[1] is not None, c[0]))
        if cands:
            return cands[0][0], cands[0][1], cands[0][1] is None
        return rank, rc, False

    def _run_loop(self):
        while True:
            failed = self._watch_generation()
            if failed is None:
                return 0                        # every rank exited 0
            rank, rc = failed
            wedged = False
            if rc == EXIT_PEER_LOST:
                rank, rc, wedged = self._root_cause(rank, rc)
            # decide on the code seen before the teardown: a 75 that
            # answers our own SIGTERM is collateral, not a preemption
            observed_rc = rc
            t_detect = time.monotonic()
            _tele.emit({"ts": time.time(), "source": "resilience",
                        "event": "rank_lost", "rank": rank,
                        "exit_code": rc, "step_time": 0.0,
                        "generation": self.generation})
            rcs = self._teardown()
            if rc is None:
                rc = rcs.get(rank)              # the wedged rank's code
            incident = {"generation": self.generation, "rank": rank,
                        "exit_code": rc, "rank_exit_codes": rcs,
                        "wedged": wedged, "ts": time.time()}
            if observed_rc == EXIT_DIVERGED:
                incident["diverged"] = True
            if observed_rc == EXIT_PREEMPTED:
                incident["action"] = "stop (preempted)"
                incident["downtime_s"] = 0.0
                self.incidents.append(incident)
                _log.warning("gang preempted (rank %d exit %d): stopping "
                             "without restart", rank, rc)
                return EXIT_PREEMPTED
            if self.restarts >= self.max_restarts:
                incident["action"] = ("give up (restart budget %d "
                                      "exhausted)" % self.max_restarts)
                incident["downtime_s"] = None
                self.incidents.append(incident)
                _log.error("gang failed (rank %d exit %s) with the restart "
                           "budget exhausted (%d/%d): giving up", rank, rc,
                           self.restarts, self.max_restarts)
                return rc if rc else 1
            backoff = min(60.0, self.backoff_s * (2.0 ** self.restarts))
            _log.warning("gang failure: rank %d exited %s (generation %d): "
                         "tearing down and relaunching in %.3gs (restart "
                         "%d/%d)", rank, rc, self.generation, backoff,
                         self.restarts + 1, self.max_restarts)
            if backoff > 0:
                time.sleep(backoff)
            self.restarts += 1
            self.generation += 1
            RESTARTS.inc()
            self.spawn()
            downtime = time.monotonic() - t_detect
            DOWNTIME.observe(downtime)
            incident["action"] = ("restart (rolled back)"
                                  if incident.get("diverged")
                                  else "restart")
            incident["downtime_s"] = round(downtime, 3)
            incident["backoff_s"] = backoff
            self.incidents.append(incident)
            _tele.emit({"ts": time.time(), "source": "resilience",
                        "event": "gang_restart", "rank": rank,
                        "exit_code": rc, "restarts": self.restarts,
                        "step_time": downtime,
                        "generation": self.generation})

    def _watch_generation(self):
        """Poll the gang: None once every rank exited 0, else (rank, rc)
        of the failure that best names the cause in the sweep that first
        saw one (a crash or signal before a 75, a 75 before a 76)."""
        while True:
            running, failures = False, []
            for rank, p in enumerate(self.procs):
                rc = p.poll()
                if rc is None:
                    running = True
                elif rc != 0:
                    failures.append((rank, rc))
            if failures:
                for rank, rc in failures:
                    if rc not in (EXIT_PEER_LOST, EXIT_PREEMPTED):
                        return rank, rc
                for rank, rc in failures:
                    if rc == EXIT_PREEMPTED:
                        return rank, rc
                return failures[0]
            if not running:
                return None
            peer_status(self.dir)      # the heartbeat-age gauge
            time.sleep(self.poll_s)

    # -- reporting -----------------------------------------------------
    def report(self):
        """The gang's lifecycle: ranks, generation, restarts and each
        incident (its rank, exit codes, action and downtime). The JAX
        package's cold-start split of a restart's downtime waits for the
        compile plane (ROADMAP A9b)."""
        return {"nranks": self.nranks, "generation": self.generation,
                "restarts": self.restarts, "gang_dir": self.dir,
                "incidents": [dict(i) for i in self.incidents]}

    def _write_report(self):
        try:
            with atomic_write(os.path.join(self.dir, "report.json"),
                              "w") as f:
                f.write(json.dumps(self.report(), sort_keys=True))
        except OSError:
            pass


def rendezvous_env(nranks, rank, port_file, host="127.0.0.1"):
    """The env a rank of a local gang gets: both namings of rank and
    world (``DMLC_*``, ``JAX_*``), a coordinator of port 0 and the port
    file through which rank 0 publishes the port it binds."""
    return {
        "DMLC_ROLE": "worker",
        "DMLC_NUM_WORKER": str(nranks),
        "DMLC_WORKER_ID": str(rank),
        "JAX_COORDINATOR_ADDRESS": "%s:0" % host,
        "JAX_NUM_PROCESSES": str(nranks),
        "JAX_PROCESS_ID": str(rank),
        "MXTPU_DIST_PORT_FILE": port_file,
    }
