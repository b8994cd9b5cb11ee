"""Which bounded wait the installed torch honours for `DistKVStore.barrier`.

Starts 2-rank gangs over one backend, each rank in a process of its own,
and prints one JSON line a case:

- "late": ``MXTPU_DIST_INIT_TIMEOUT_S=3`` and rank 1 reaches the barrier
  8 s after rank 0: the init knob bounds the rendezvous alone, so both
  ranks pass the barrier and rank 0 waited more than 3 s.
- "never": ``MXTPU_BARRIER_TIMEOUT_S=2`` and rank 1 never reaches the
  barrier: rank 0's barrier raises `DeadlineExceeded` after 2 to 10 s.

    python tools/torch_barrier_check.py --backend nccl   # two cards
    python tools/torch_barrier_check.py --backend gloo   # the CPU

NCCL needs a card for each rank (rank r uses cuda:r). Exits 0 when both
cases behave as described, else 1.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_S = 60


def worker(coordinator, rank, mode, flag, backend):
    sys.path.insert(0, HERE)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel.kvstore_dist import init_distributed
    from mxnet_tpu_torch.resilience.retry import DeadlineExceeded
    ctx = mx.cpu() if backend == "gloo" else mx.gpu(rank)
    with ctx:
        init_distributed(coordinator, 2, rank)
        kv = mx.kv.create("dist_sync")
        if mode == "late":
            if rank == 1:
                time.sleep(8)
            t0 = time.monotonic()
            kv.barrier()
            print("BARRIER_OK_%d %.3f" % (rank, time.monotonic() - t0),
                  flush=True)
        elif rank == 0:
            t0 = time.monotonic()
            try:
                kv.barrier()
                print("BARRIER_RETURNED %.3f" % (time.monotonic() - t0),
                      flush=True)
            except DeadlineExceeded as err:
                print("DEADLINE %.3f %s" % (time.monotonic() - t0, err),
                      flush=True)
            except Exception as err:   # noqa: BLE001 — reported as found
                print("OTHER_ERROR %.3f %s: %s" % (
                    time.monotonic() - t0, type(err).__name__, err),
                    flush=True)
            open(flag, "w").close()
        else:
            t0 = time.monotonic()
            while not os.path.exists(flag) and time.monotonic() - t0 < 40:
                time.sleep(0.1)
            print("PEER_LEFT", flush=True)
    # the never-met barrier is still pending: leave without teardown
    os._exit(0)


def gang(mode, backend, env):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coordinator = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    flag = os.path.join(tempfile.gettempdir(),
                        "torch_barrier_check_%d_%s" % (os.getpid(), mode))
    env = dict(os.environ, MXTPU_DIST_BACKEND=backend, **env)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         coordinator, str(r), mode, flag, backend], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    t0 = time.monotonic()
    outs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=max(1.0, GANG_S -
                                               (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        outs.append((p.returncode, log.decode(errors="replace")))
    if os.path.exists(flag):
        os.remove(flag)
    return outs


def first(log, tag):
    for line in log.splitlines():
        if line.startswith(tag):
            return line
    return None


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        c, r, mode, flag, backend = sys.argv[2:7]
        worker(c, int(r), mode, flag, backend)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    args = ap.parse_args()
    ok = True
    outs = gang("late", args.backend, {"MXTPU_DIST_INIT_TIMEOUT_S": "3"})
    lines = [first(log, "BARRIER_OK_%d" % r) for r, (_, log) in
             enumerate(outs)]
    waited = float(lines[0].split()[1]) if lines[0] else None
    good = all(rc == 0 for rc, _ in outs) and all(lines) and waited > 3.0
    ok &= good
    print(json.dumps(dict(backend=args.backend, case="late", passed=good,
                          rank0_waited_s=waited, rcs=[rc for rc, _ in outs],
                          tails=[log[-1500:] for _, log in outs]
                          if not good else None)), flush=True)
    outs = gang("never", args.backend, {"MXTPU_BARRIER_TIMEOUT_S": "2"})
    (rc0, log0), (rc1, log1) = outs
    line = first(log0, "DEADLINE") or first(log0, "BARRIER_RETURNED") or \
        first(log0, "OTHER_ERROR")
    waited = float(line.split()[1]) if line else None
    good = rc0 == 0 and line is not None and line.startswith("DEADLINE") \
        and 2.0 <= waited < 10.0 and rc1 == 0 and "PEER_LEFT" in log1
    ok &= good
    print(json.dumps(dict(backend=args.backend, case="never", passed=good,
                          rank0=line, rank0_waited_s=waited, rcs=[rc0, rc1],
                          tails=[log0[-1500:], log1[-1500:]]
                          if not good else None)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
