"""ResNet-50 v1 through the port's process-spanning `ShardedTrainer`
across cards over NCCL: one process a card, started as a user starts a
gang (``tools/launch.py -n N``).

    python tools/torch_dist_sharded.py --nproc 4 [--steps 10]
        [--batch 128] [--img 224] [--no-zero1]

Every rank builds ResNet-50 v1 (NHWC) from one seed, takes the same
global batch (``--batch``, split over the ranks by the trainer) and
trains it with bf16 compute over fp32 masters, SGD momentum 0.9, the
CUDA-graph step, global-batch BatchNorm and (unless ``--no-zero1``)
ZeRO-1, on the mesh ``{"dp": N}`` over the gang: a first window of
``--steps`` steps (warm-up and capture included), then a timed window.
Rank 0 then trains the same weights on the whole batch on its card
alone (a one-card mesh) and compares the first window's losses. It
prints one JSON line: the cards, ranks, img/s and step ms of the timed
window (host clock, fenced by reading the losses back), the losses of
both runs, their largest relative difference, and whether the ranks'
weights are bit-identical (their fp64 checksums, all-gathered). Exits 1
when a rank fails, the losses are not finite, or the ranks differ.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None


def worker(args):
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh
    from mxnet_tpu_torch.parallel.kvstore_dist import (init_distributed,
                                                       rank_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed()
    rank, nproc = dist.get_rank(), dist.get_world_size()
    dev = rank_device()
    with mx.gpu(dev.index):
        net = resnet50_v1(layout="NHWC", device=dev)
        init_resnet_params(net, seed=0)
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(args.batch, args.img, args.img, 3)
                             .astype("float32")).to(dev)
        y = torch.from_numpy((rng.rand(args.batch) * 1000)
                             .astype("float32")).to(dev)

        def trainer(**kw):
            return ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9},
                                  compute_dtype="bfloat16", **kw)
        st = trainer(shard_optimizer_state=args.zero1)
        t = time.perf_counter()
        first = st.step_many(x, y, n_steps=args.steps).cpu()
        first_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        timed = st.step_many(x, y, n_steps=args.steps).cpu()
        wall = time.perf_counter() - t
        check = torch.tensor([float(sum(v.double().sum() for v in
                                        st.params.values()))],
                             dtype=torch.float64, device=dev)
        sums = [torch.zeros_like(check) for _ in range(nproc)]
        dist.all_gather(sums, check)
        out = dict(rank=rank, nproc=nproc, backend=dist.get_backend(),
                   mesh=st._mesh.shape, zero1_parameters=len(st._zero),
                   graphs=len(st._graphs), first_window_s=first_s,
                   img_s=args.batch * args.steps / wall,
                   step_ms=wall / args.steps * 1e3,
                   losses=first.tolist(), losses_timed=timed.tolist(),
                   ranks_bit_identical=len({float(s) for s in sums}) == 1)
        del st
        dist.destroy_process_group()
        if rank == 0:
            one = trainer(mesh=make_mesh({"dp": 1}, devices=[dev]))
            ref = one.step_many(x, y, n_steps=args.steps).cpu()
            out["one_card_losses"] = ref.tolist()
            out["max_loss_rel_diff"] = float(
                ((first - ref).abs() / ref.abs()).max())
            out["card"] = _card()
            print(json.dumps(out), flush=True)
    ok = out["ranks_bit_identical"] and bool(torch.isfinite(first).all())
    sys.exit(0 if ok else 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--img", type=int, default=224)
    ap.add_argument("--no-zero1", dest="zero1", action="store_false")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return
    cmd = [sys.executable, os.path.join(HERE, "tools", "launch.py"), "-n",
           str(args.nproc), sys.executable, os.path.abspath(__file__),
           "--worker", "--steps", str(args.steps), "--batch",
           str(args.batch), "--img", str(args.img)]
    if not args.zero1:
        cmd.append("--no-zero1")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MXTPU_DIST_BACKEND", "MXTPU_CUDA_GRAPH")}
    sys.exit(subprocess.run(cmd, cwd=HERE, env=env).returncode)


if __name__ == "__main__":
    main()
