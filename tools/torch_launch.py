#!/usr/bin/env python
"""Local gang launcher for the PyTorch port (mxnet_tpu_torch).

Starts N copies of a command on this host with the rendezvous the port
reads, forwards their output with a ``[rank] `` prefix and returns the
first non-zero exit code (0 when every rank succeeded): the ``-n``
contract of tools/launch.py. Each rank gets, in both namings::

    DMLC_ROLE=worker  DMLC_NUM_WORKER=<n>  DMLC_WORKER_ID=<rank>
    JAX_NUM_PROCESSES=<n>  JAX_PROCESS_ID=<rank>
    JAX_COORDINATOR_ADDRESS=127.0.0.1:0  MXTPU_DIST_PORT_FILE=<file>

Where tools/launch.py probes a free port, closes it and hands it to the
ranks (another process can take it in between), the coordinator here has
port 0: rank 0's store binds a free port itself and publishes it in the
port file, which the other ranks wait for
(`mxnet_tpu_torch.parallel.kvstore_dist.init_distributed`). Nothing is
probed, so any number of gangs can start at once.

``--supervise`` runs the ranks under
`mxnet_tpu_torch.resilience.GangSupervisor`: a rank's death tears the
others down and relaunches the gang (bounded by ``--max-restarts`` /
``MXTPU_MAX_RESTARTS``, with exponential backoff ``--restart-backoff`` /
``MXTPU_RESTART_BACKOFF_S``), each generation with a port file of its
own, ``MXTPU_CHAOS_RANK_*`` stripped after the first; the ranks resume
from their latest committed checkpoint. It prints one ``GANG_REPORT
<json>`` line and writes ``<gang-dir>/report.json``. Exit codes: 0 done,
75 preempted, else the failing rank's (128 + signal for a killed one).

Usage::

    python tools/torch_launch.py -n 2 python tests/torch_dist_worker.py
    python tools/torch_launch.py -n 2 --supervise --gang-dir /tmp/g \\
        python tests/torch_gang_worker.py --mode gang ...

The plain mode imports nothing but the standard library.
"""
import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading


def rank_env(base, n, rank, port_file):
    """`base` plus the rendezvous of rank `rank` of `n` (the block
    `mxnet_tpu_torch.resilience.supervisor.rendezvous_env` builds for
    supervised gangs)."""
    env = dict(base)
    env.update({
        "DMLC_ROLE": "worker",
        "DMLC_NUM_WORKER": str(n),
        "DMLC_WORKER_ID": str(rank),
        "JAX_COORDINATOR_ADDRESS": "127.0.0.1:0",
        "JAX_NUM_PROCESSES": str(n),
        "JAX_PROCESS_ID": str(rank),
        "MXTPU_DIST_PORT_FILE": port_file,
    })
    return env


def _pump(prefix, stream, out):
    for line in iter(stream.readline, b""):
        out.write("%s%s" % (prefix, line.decode(errors="replace")))
        out.flush()


def launch_local(n, command, env=None):
    """Run `n` local ranks of `command`; the first non-zero exit code, or
    0. A port file of its own in a fresh directory, removed after."""
    tmp = tempfile.mkdtemp(prefix="mxtpu_launch_")
    port_file = os.path.join(tmp, "port")
    base = os.environ if env is None else env
    procs, pumps = [], []
    try:
        for rank in range(n):
            p = subprocess.Popen(command,
                                 env=rank_env(base, n, rank, port_file),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            t = threading.Thread(target=_pump, args=(
                "[%d] " % rank, p.stdout, sys.stdout), daemon=True)
            t.start()
            procs.append(p)
            pumps.append(t)
        rc = 0
        try:
            for p in procs:
                p.wait()
                if p.returncode and not rc:
                    rc = p.returncode
        except KeyboardInterrupt:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            for p in procs:
                p.wait()
            rc = 130
        for t in pumps:
            t.join(timeout=2)
        return rc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def launch_supervised(n, command, gang_dir=None, max_restarts=None,
                      backoff_s=None):
    """Run `n` local ranks under a GangSupervisor; prints the GANG_REPORT
    line and returns the gang's exit code."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from mxnet_tpu_torch.resilience.supervisor import GangSupervisor
    sup = GangSupervisor(command, n, gang_dir=gang_dir,
                         max_restarts=max_restarts, backoff_s=backoff_s)
    rc = sup.run()
    print("GANG_REPORT %s" % json.dumps(dict(sup.report(), exit_code=rc),
                                        sort_keys=True))
    sys.stdout.flush()
    if rc < 0:
        rc = 128 - rc          # a killed rank: the shell's 128 + signal
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Launch a local gang of the PyTorch port's ranks")
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="number of ranks")
    ap.add_argument("--supervise", action="store_true",
                    help="run the gang under a GangSupervisor")
    ap.add_argument("--gang-dir", default=None,
                    help="gang state directory (--supervise)")
    ap.add_argument("--max-restarts", type=int, default=None)
    ap.add_argument("--restart-backoff", type=float, default=None)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        ap.error("no command given")
    if args.num_workers < 1:
        ap.error("-n must be at least 1")
    if args.supervise:
        return launch_supervised(args.num_workers, command, args.gang_dir,
                                 args.max_restarts, args.restart_backoff)
    return launch_local(args.num_workers, command)


if __name__ == "__main__":
    sys.exit(main())
