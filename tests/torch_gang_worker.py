"""One rank of a supervised training gang of the PyTorch port, for the
preemption, gang-restart and divergence-rollback drills (the port's
counterpart of tests/gang_worker.py and tests/numerics_worker.py). It
imports torch and the port only.

    python tools/torch_launch.py -n 2 --supervise --gang-dir G \\
        python tests/torch_gang_worker.py --steps 6 --ckpt-dir C --out O

A rank trains a model (``--model mlp``, or ``resnet``: a narrow NHWC
ResNet V1, BottleneckV1 [1, 1], [16, 32, 64], 10 classes) through
`gluon.Trainer` (SGD, momentum 0.9) on seeded batches that are a
function of the step alone, each rank its rows of the step's global
batch; across processes over ``kvstore="dist_sync"`` (gloo, or NCCL on
cards of their own), whose collectives poll the gang's heartbeats. At
the top of every step, after the preemption boundary, the gang saves a
`TrainerCheckpoint` of the steps done (the parameters with the BatchNorm
statistics, the momenta and the step), committed by rank 0 after the
gang's barrier; at start every rank restores the newest committed step,
so a run that was killed, preempted or rolled back and then relaunched
ends bit-identical to one that was not.

Drills: ``--sigterm-at K`` makes every rank SIGTERM itself after step K
(under a `PreemptionGuard.for_trainer`: save at the next boundary, exit
75); ``MXTPU_CHAOS_RANK_<r>="worker.kill:kind=kill,after=N"`` kills a
rank at its N+1-th step boundary (two a step: the loop's and
`Trainer.step`'s); ``grad.post:kind=nan`` with
``MXTPU_DIVERGE_PATIENCE`` arms the guard's rollback (exit 77). Exit
codes through `run_supervised`.

Each rank appends JSON lines to ``<out>.r<rank>.jsonl``: ``start``
(restored step, generation, the rank chaos it was given), ``step``
(step, loss) and ``done`` (step, sha256 of the trained parameters and
momenta, the same on every rank, and of this rank's BatchNorm running
statistics: rank 0's are the checkpoint's, so a resumed rank 0 matches
an uninterrupted one in those too).
"""
import argparse
import hashlib
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class GluonState:
    """A `gluon.Trainer` and its net in the shape `TrainerCheckpoint`
    saves and restores (`_global_state`, `_global_shapes`,
    `_load_global_state`, `_step_count`): every parameter by name (the
    BatchNorm statistics included), each momentum by parameter index, the
    count of steps done."""

    def __init__(self, net, trainer):
        self.net = net
        self.trainer = trainer
        self._step_count = 0

    def _params(self):
        return {k[len(self.net.prefix):]: p
                for k, p in self.net.collect_params().items()}

    def _states(self):
        tr = self.trainer
        up = tr._updaters[0]
        for i, p in tr._trainable():
            up._state_of(i, p.data())
        return {str(i): up.states[i] for i, _ in tr._trainable()}

    def _global_state(self):
        import torch
        with torch.no_grad():
            return {"params": {k: p.data().detach().cpu().clone()
                               for k, p in self._params().items()},
                    "aux": {},
                    "opt_state": {k: s.detach().cpu().clone()
                                  for k, s in self._states().items()},
                    "step": int(self._step_count)}

    def _global_shapes(self):
        return {"params": {k: tuple(p.data().shape)
                           for k, p in self._params().items()},
                "aux": {},
                "opt_state": {k: tuple(s.shape)
                              for k, s in self._states().items()},
                "step": None}

    def _load_global_state(self, state):
        import torch
        with torch.no_grad():
            for k, p in self._params().items():
                d = p.data()
                d.copy_(state["params"][k].to(d.device, d.dtype))
            for k, s in self._states().items():
                s.copy_(state["opt_state"][k].to(s.device, s.dtype))
        self._step_count = int(state["step"])

    def digests(self):
        """sha256 of the trained parameters and the momenta (the same on
        every rank), and of the running statistics (each rank's own: a
        data-parallel BatchNorm keeps its batch's; the checkpoint holds
        rank 0's)."""
        trained, stats = hashlib.sha256(), hashlib.sha256()
        for _, p in sorted(self._params().items()):
            (stats if p.grad_req == "null" else trained).update(
                p.data().detach().cpu().contiguous().numpy().tobytes())
        for _, s in sorted(self._states().items()):
            trained.update(s.detach().cpu().contiguous().numpy().tobytes())
        return trained.hexdigest(), stats.hexdigest()


def _net(model, device, ctx):
    import mxnet_tpu_torch as mx
    if model == "resnet":
        from mxnet_tpu_torch.convert import init_resnet_params
        from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                            ResNetV1)
        net = ResNetV1(BottleneckV1, [1, 1], [16, 32, 64], classes=10,
                       layout="NHWC", device=device)
        init_resnet_params(net, seed=3)
        return net, (32, 32, 3)
    mx.random.seed(3)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(32, activation="relu", in_units=16))
        net.add(mx.gluon.nn.Dense(10, in_units=32))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net, (16,)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8,
                    help="the global batch of a step")
    ap.add_argument("--model", choices=("mlp", "resnet"), default="mlp")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--sigterm-at", type=int, default=None)
    ap.add_argument("--pause", type=float, default=0.0,
                    help="seconds to sleep after each step")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel.checkpoint import TrainerCheckpoint
    from mxnet_tpu_torch.parallel.kvstore_dist import init_distributed
    from mxnet_tpu_torch.resilience import (PreemptionGuard,
                                            at_step_boundary,
                                            run_supervised)

    torch.set_num_threads(1)
    if args.device == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ.get("JAX_PROCESS_ID", 0))
    ctx = mx.cpu() if args.device == "cpu" else \
        mx.gpu(rank % torch.cuda.device_count())
    with ctx:
        init_distributed()
        import torch.distributed as dist
        nproc = dist.get_world_size() if dist.is_initialized() else 1
        device = torch.device("cpu") if args.device == "cpu" else \
            torch.device("cuda", rank % torch.cuda.device_count())
        out_path = "%s.r%d.jsonl" % (args.out, rank)

        def emit(rec):
            with open(out_path, "a") as f:
                f.write(json.dumps(dict(rec, rank=rank), sort_keys=True)
                        + "\n")

        net, shape = _net(args.model, device, ctx)
        trainer = mx.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
            kvstore="dist_sync" if nproc > 1 else None)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        state = GluonState(net, trainer)
        ck = TrainerCheckpoint(args.ckpt_dir)
        restored = ck.restore_latest(state)
        # the step records and the guard's numbering go on across
        # generations
        trainer._telemetry.step = state._step_count
        if trainer.numerics is not None:
            trainer.numerics.attach_rollback(ck, state)
        emit({"event": "start", "restored_step": restored,
              "generation": int(os.environ.get("MXTPU_GANG_GENERATION",
                                               -1)),
              "rank_chaos": sorted(k for k in os.environ
                                   if k.startswith("MXTPU_CHAOS_RANK_"))})

        def batch(step):
            rng = np.random.RandomState(1000 + step)
            x = rng.randn(args.batch, *shape).astype(np.float32)
            y = (rng.rand(args.batch) * 10).astype(np.int64) \
                .astype(np.float32)
            rows = slice(rank, None, nproc)
            return (torch.from_numpy(x[rows]).to(device),
                    torch.from_numpy(y[rows]).to(device))

        saved = [restored or 0]

        def save():
            """Commit the steps done, once: at the top of the next step,
            after the preemption boundary (whose own save takes it when a
            signal is pending), and at the end. Every rank calls it at the
            same point: the commit is a barrier of the gang."""
            if state._step_count > saved[0]:
                ck.save(state._step_count, state, wait=True)
                saved[0] = state._step_count

        def body():
            with PreemptionGuard.for_trainer(ck, state):
                for step in range(state._step_count, args.steps):
                    at_step_boundary()
                    save()
                    x, y = batch(step)
                    with mx.autograd.record():
                        loss = loss_fn(net(x), y)
                    loss.backward()
                    trainer.step(args.batch)
                    state._step_count = step + 1
                    emit({"event": "step", "step": state._step_count,
                          "loss": float(loss.astorch().detach().float()
                                        .mean())})
                    if args.sigterm_at == state._step_count:
                        os.kill(os.getpid(), signal.SIGTERM)
                    time.sleep(args.pause)
                at_step_boundary()
                save()
            digest, stats = state.digests()
            emit({"event": "done", "step": state._step_count,
                  "digest": digest, "stats_digest": stats})
            print("GANG_WORKER_%d_DONE" % rank, flush=True)

        run_supervised(body)


if __name__ == "__main__":
    main()
