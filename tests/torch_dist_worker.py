"""One rank of a torch.distributed gang driving the port's distributed
KVStore (the port's counterpart of tests/dist_kvstore_worker.py). It
imports torch and the port only.

    python tests/torch_dist_worker.py COORDINATOR NPROC RANK [--out DIR]
    python tools/launch.py -n 4 python tests/torch_dist_worker.py [--out DIR]

The first form joins the gang named on the command line; the second reads
the rendezvous that tools/launch.py exports. Each rank runs on the CPU
over gloo unless ``--device cuda`` puts it on ``cuda:(rank % cards)``
(with ``MXTPU_DIST_BACKEND=gloo`` two ranks can share one card). It
asserts the store's exact sums and API (dense fp32 over rounds, fp16, a
key larger than a bucket, repeated keys, the updater path, bucketed
against per-key bit for bit with one collective per bucket, 2-bit
compression on the wire), then trains and writes what the tests compare
to ``DIR/rank<r>.npz``:

- ``mlp_fused_*``, ``mlp_staged_*``: an MLP through `gluon.Trainer`
  over 'dist_sync', 3 steps, fused then staged, from the same weights;
- ``mlp_comp_*``: the same, staged, with 2-bit compression;
- ``resnet_fused_*``, ``resnet_staged_*``: a narrow NHWC ResNet V1 with
  BatchNorm (each rank's own statistics), fused then staged, its
  gradients in several 0.25 MB fusion buckets;
- ``module_*``: `Module.fit(kvstore="dist_sync")` over an MLP symbol;
- ``counts``: launches a fused MLP step, its flats and its groups;
- ``launches_resnet_*``: the ResNet runs' conv1x1_bn_stats and
  fused_sgd_momentum launches (none on the CPU).

It prints ``WORKER_<rank>_OK`` at the end. The data and the one-process
oracles (`resnet_oracle`, `compressed_mlp_oracle`) are functions here,
so the tests and chip_smoke.py build the same batches.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

STEPS = 3
LRS = (0.1, 0.05, 0.025)
OPT = {"learning_rate": LRS[0], "momentum": 0.9, "wd": 1e-4}
MLP = dict(in_units=10, hidden=16, classes=4, batch=4)
RESNET = dict(layers=[1, 1], channels=[16, 32, 64], classes=10, img=32)
COMP = {"type": "2bit", "threshold": 0.1}


# -- the data, the same for every caller -------------------------------------
def mlp_weights():
    rng = np.random.RandomState(0)
    m = MLP
    return [rng.uniform(-0.5, 0.5, (m["hidden"], m["in_units"])),
            rng.uniform(-0.1, 0.1, (m["hidden"],)),
            rng.uniform(-0.5, 0.5, (m["classes"], m["hidden"])),
            rng.uniform(-0.1, 0.1, (m["classes"],))]


def mlp_batch(step, rank):
    rng = np.random.RandomState(1000 + 10 * step + rank)
    x = rng.randn(MLP["batch"], MLP["in_units"]).astype(np.float32)
    y = rng.randint(0, MLP["classes"], MLP["batch"]).astype(np.float32)
    return x, y


def resnet_batch(step, rank, batch):
    rng = np.random.RandomState(2000 + 10 * step + rank)
    x = rng.randn(batch, RESNET["img"], RESNET["img"], 3).astype(np.float32)
    y = (rng.randint(0, RESNET["classes"], batch)).astype(np.float32)
    return x, y


def build_mlp(mx, device):
    from mxnet_tpu_torch import gluon
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(MLP["hidden"], activation="relu",
                               in_units=MLP["in_units"], device=device))
        net.add(gluon.nn.Dense(MLP["classes"], in_units=MLP["hidden"],
                               device=device))
    net.initialize(ctx=mx.cpu() if device.type == "cpu" else mx.gpu(
        device.index))
    params = [p for p in net.collect_params().values()]
    for p, w in zip(params, mlp_weights()):
        p.set_data(torch.tensor(w, dtype=torch.float32, device=device))
    return net


def build_resnet(device):
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.model_zoo.vision import (BottleneckV1,
                                                        ResNetV1)
    net = ResNetV1(BottleneckV1, RESNET["layers"], RESNET["channels"],
                   classes=RESNET["classes"], layout="NHWC", device=device)
    init_resnet_params(net, seed=3)
    return net


def param_arrays(net, tag):
    """{tag_i: array} in Gluon's order, running statistics included."""
    return {"%s_%d" % (tag, i): p.data().detach().float().cpu().numpy()
            for i, p in enumerate(net.collect_params().values())}


def _step(net, trainer, x, y, n):
    from mxnet_tpu_torch import autograd, gluon
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    trainer.step(n)


def train(mx, kind, device, rank, nproc, kvstore="dist_sync", fused=True,
          compression=None, batch=2):
    """`STEPS` steps of `kind` ('mlp' or 'resnet') through gluon.Trainer,
    lr changing every step. Returns (net, trainer)."""
    from mxnet_tpu_torch import gluon
    os.environ["MXTPU_FUSED_STEP"] = "1" if fused else "0"
    net = build_mlp(mx, device) if kind == "mlp" else build_resnet(device)
    if kind == "resnet":
        # several fusion buckets (the net's gradients are ~0.8 MB)
        kvstore = mx.kv.create(kvstore)
        kvstore.set_bucket_size_mb(0.25)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(OPT),
                       kvstore=kvstore, compression_params=compression)
    per = MLP["batch"] if kind == "mlp" else batch
    for s in range(STEPS):
        tr.set_learning_rate(LRS[s])
        x, y = mlp_batch(s, rank) if kind == "mlp" \
            else resnet_batch(s, rank, batch)
        _step(net, tr, torch.from_numpy(x).to(device),
              torch.from_numpy(y).to(device), per * nproc)
    os.environ.pop("MXTPU_FUSED_STEP", None)
    return net, tr


# -- the one-process oracles -------------------------------------------------
def resnet_oracle(mx, device, nproc, batch):
    """One net per rank, each rank's gradients summed in rank order and the
    same update applied to every net: {rank: param arrays}."""
    from mxnet_tpu_torch import autograd, gluon
    nets = [build_resnet(device) for _ in range(nproc)]
    trs = [gluon.Trainer(n.collect_params(), "sgd", dict(OPT),
                         kvstore=None) for n in nets]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for s in range(STEPS):
        grads = []
        for r, net in enumerate(nets):
            x, y = resnet_batch(s, r, batch)
            with autograd.record():
                loss = loss_fn(net(torch.from_numpy(x).to(device)),
                               torch.from_numpy(y).to(device))
            loss.backward()
            grads.append([p.grad().clone()
                          for p in net.collect_params().values()
                          if p.grad_req != "null"])
        total = grads[0]
        for g in grads[1:]:
            total = [a + b for a, b in zip(total, g)]
        for net, tr in zip(nets, trs):
            live = [p for p in net.collect_params().values()
                    if p.grad_req != "null"]
            for p, g in zip(live, total):
                p._grad = g.clone()
            tr.set_learning_rate(LRS[s])
            tr.step(batch * nproc)
    return {r: param_arrays(net, "resnet") for r, net in enumerate(nets)}


def compressed_mlp_oracle(mx, device, nproc):
    """The compressed exchange in one process: each rank's gradients
    quantized with its own residuals, every rank's codes dequantized and
    added in rank order, then the update: the MLP's param arrays."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gradient_compression import (dequantize_2bit,
                                                      quantize_2bit)
    net = build_mlp(mx, device)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(OPT), kvstore=None)
    live = list(net.collect_params().values())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    thr = COMP["threshold"]
    res = {(r, i): torch.zeros_like(p.data()) for r in range(nproc)
           for i, p in enumerate(live)}
    for s in range(STEPS):
        total = None
        for r in range(nproc):
            x, y = mlp_batch(s, r)
            with autograd.record():
                loss = loss_fn(net(torch.from_numpy(x).to(device)),
                               torch.from_numpy(y).to(device))
            loss.backward()
            dec = []
            for i, p in enumerate(live):
                words, res[r, i] = quantize_2bit(p.grad(), res[r, i], thr)
                dec.append(dequantize_2bit(words, p.grad().shape, thr))
            total = dec if total is None else \
                [a + b for a, b in zip(total, dec)]
        for p, g in zip(live, total):
            p._grad = g
        tr.set_learning_rate(LRS[s])
        tr.step(MLP["batch"] * nproc)
    return param_arrays(net, "mlp_comp")


# -- the rank ----------------------------------------------------------------
def check_store(mx, device, rank, nproc):
    """The store's exact sums and API (dist_kvstore_worker.py's cases)."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.observability import registry
    kv = mx.kv.create("dist_sync")
    assert kv.num_workers == nproc and kv.rank == rank, \
        (kv.num_workers, kv.rank)
    full = lambda shape, v, dt=torch.float32: torch.full(  # noqa: E731
        shape, float(v), dtype=dt, device=device)
    shape = (3, 4)
    kv.init("dense", full(shape, 0))
    for rnd in range(3):
        kv.push("dense", full(shape, rank + 1 + rnd))
        out = full(shape, 0)
        kv.pull("dense", out=out)
        assert (out == sum(r + 1 + rnd for r in range(nproc))).all(), rnd
    kv.init("half", full(shape, 0, torch.float16))
    kv.push("half", full(shape, rank + 1, torch.float16))
    out = full(shape, 0, torch.float16)
    kv.pull("half", out=out)
    assert out.dtype == torch.float16 and \
        (out == sum(r + 1 for r in range(nproc))).all()
    # a key larger than a bucket rides alone
    kv.set_bucket_size_mb(0.001)
    kv.init("big", full((129, 33), 0))
    kv.init("small", full((5,), 0))
    kv.push_all(["big", "small"], [full((129, 33), rank + 1),
                                   full((5,), 2 * rank)])
    outs = [full((129, 33), 0), full((5,), 0)]
    kv.pull_all(["big", "small"], outs)
    assert (outs[0] == sum(r + 1 for r in range(nproc))).all()
    assert (outs[1] == sum(2 * r for r in range(nproc))).all()
    # a repeated key: each push lands in turn, the last one stays
    kv.push_all(["small", "small"], [full((5,), rank), full((5,), 1)])
    kv.pull("small", out=outs[1])
    assert (outs[1] == nproc).all(), outs[1]
    # the updater path: the same SGD step on every rank
    kvu = mx.kv.create("dist_sync")
    kvu.init("w", full((4,), 1))
    kvu.set_optimizer(optimizer.SGD(learning_rate=0.1))
    kvu.push("w", full((4,), rank))
    out = full((4,), 0)
    kvu.pull("w", out=out)
    want = torch.tensor(1.0 - 0.1 * sum(range(nproc)), dtype=torch.float32)
    assert torch.allclose(out.cpu(), want.expand(4), atol=1e-6), out
    # bucketed against per-key, bit for bit, one collective per bucket
    ar = registry.counter("kvstore.allreduce.calls")
    buckets = registry.counter("kvstore.bucket.count")
    kb = mx.kv.create("dist_sync")
    kp = mx.kv.create("dist_sync")
    kp.set_bucket_size_mb(0)
    rng = np.random.RandomState(1234 + rank)
    specs = [((11,), torch.float32), ((4, 7), torch.float32),
             ((130,), torch.float32), ((3, 5, 2), torch.float32),
             ((64,), torch.float16), ((9, 3), torch.float16)]
    keys = ["bk%d" % i for i in range(len(specs))]
    grads = []
    for k, (shp, dt) in zip(keys, specs):
        kb.init(k, full(shp, 0, dt))
        kp.init(k, full(shp, 0, dt))
        grads.append(torch.tensor(rng.randint(-4, 5, shp), dtype=dt,
                                  device=device))
    prios = [-i for i in range(len(keys))]
    c0, b0 = ar.get(), buckets.get()
    kb.push_all(keys, grads, priorities=prios)
    assert ar.get() - c0 == buckets.get() - b0 == 2, \
        (ar.get() - c0, buckets.get() - b0)
    c1 = ar.get()
    kp.push_all(keys, grads, priorities=prios)
    assert ar.get() - c1 == len(keys)
    for k, (shp, dt) in zip(keys, specs):
        a, b = full(shp, 0, dt), full(shp, 0, dt)
        kb.pull(k, out=a)
        kp.pull(k, out=b)
        assert torch.equal(a, b), k
    # 2-bit compression: each rank pushes 0.7 against threshold 1.0; with
    # error feedback each rank's decoded sequence is 0, 1, 1
    kc = mx.kv.create("dist_sync")
    kc.set_gradient_compression({"type": "2bit", "threshold": 1.0})
    cshape = (64, 4)
    kc.init("cmp", full(cshape, 0))
    for rnd, per_rank in enumerate([0.0, 1.0, 1.0]):
        kc.push("cmp", full(cshape, 0.7))
        out = full(cshape, 0)
        kc.pull("cmp", out=out)
        assert (out == per_rank * nproc).all(), (rnd, out[0, 0])
    assert kc.last_wire_bytes * 16 <= 64 * 4 * 4 + 64
    # compressed, bucketed against per-key, over 3 rounds
    kbc, kpc = mx.kv.create("dist_sync"), mx.kv.create("dist_sync")
    kpc.set_bucket_size_mb(0)
    for s in (kbc, kpc):
        s.set_gradient_compression({"type": "2bit", "threshold": 1.0})
    cshapes = [(40,), (7, 9), (33,)]
    ckeys = ["ck%d" % i for i in range(len(cshapes))]
    for k, shp in zip(ckeys, cshapes):
        kbc.init(k, full(shp, 0))
        kpc.init(k, full(shp, 0))
    rngc = np.random.RandomState(77 + rank)
    for rnd in range(3):
        cg = [torch.tensor(rngc.randint(-3, 4, shp), dtype=torch.float32,
                           device=device) for shp in cshapes]
        c2 = ar.get()
        kbc.push_all(ckeys, cg, priorities=[0, -1, -2])
        assert ar.get() - c2 == 1
        kpc.push_all(ckeys, cg, priorities=[0, -1, -2])
        for k, shp in zip(ckeys, cshapes):
            a, b = full(shp, 0), full(shp, 0)
            kbc.pull(k, out=a)
            kpc.pull(k, out=b)
            assert torch.equal(a, b), (rnd, k)
    kv.barrier()


def train_module(mx, device, rank):
    """Module.fit over 'dist_sync' (update on the store), rank-specific
    batches from one seed for the weights."""
    data = mx.sym.var("data")
    s = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    s = mx.sym.Activation(s, act_type="relu")
    s = mx.sym.FullyConnected(s, num_hidden=4, name="fc2")
    s = mx.sym.SoftmaxOutput(s, name="softmax")
    rng = np.random.RandomState(3 + rank)
    X = rng.randn(16, 10).astype(np.float32)
    Y = rng.randint(0, 4, 16).astype(np.float32)
    it = mx.io.NDArrayIter(X, Y, batch_size=8, label_name="softmax_label")
    ctx = mx.cpu() if device.type == "cpu" else mx.gpu(device.index)
    mod = mx.mod.Module(s, data_names=("data",),
                        label_names=("softmax_label",), context=ctx)
    mx.random.seed(0)
    mod.fit(it, num_epoch=2, kvstore="dist_sync", optimizer="sgd",
            initializer=mx.init.Uniform(0.1),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    args, _ = mod.get_params()
    return {"module_%s" % k: v.asnumpy() for k, v in sorted(args.items())}


def run(device, rank, nproc, batch):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.observability import registry
    results = {}
    check_store(mx, device, rank, nproc)
    print("STORE_OK_%d" % rank, flush=True)
    disp = registry.counter("train.step.dispatches")
    groups = registry.counter("optimizer.fused.groups")
    d0, g0 = disp.get(), groups.get()
    net, tr = train(mx, "mlp", device, rank, nproc, fused=True)
    owner = tr._updaters[0]._fused_step_owner
    flats = sum(len(gf.flats) for gf in owner._grad_flats.values())
    results["counts"] = np.array([disp.get() - d0, flats,
                                  groups.get() - g0, STEPS])
    results.update(param_arrays(net, "mlp_fused"))
    results.update(param_arrays(
        train(mx, "mlp", device, rank, nproc, fused=False)[0],
        "mlp_staged"))
    results.update(param_arrays(
        train(mx, "mlp", device, rank, nproc, fused=False,
              compression=COMP)[0], "mlp_comp"))
    for fused in (True, False):
        tag = "resnet_%s" % ("fused" if fused else "staged")
        mx.ops.reset_launch_counts()
        results.update(param_arrays(
            train(mx, "resnet", device, rank, nproc, fused=fused,
                  batch=batch)[0], tag))
        n = mx.ops.launch_counts()
        results["launches_" + tag] = np.array(
            [n["conv1x1_bn_stats"], n["fused_sgd_momentum"]])
    results.update(train_module(mx, device, rank))
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rendezvous", nargs="*",
                    help="COORDINATOR NPROC RANK (else the launcher's env)")
    ap.add_argument("--out", default=None, help="write rank<r>.npz here")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--resnet-batch", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)          # the oracles run with one thread too
    # full fp32 on the card, as chip_smoke.py runs the oracles
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel.kvstore_dist import (init_distributed,
                                                       rank_device)
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)
    with ctx:
        if args.rendezvous:
            coordinator, nproc, rank = (args.rendezvous[0],
                                        int(args.rendezvous[1]),
                                        int(args.rendezvous[2]))
            init_distributed(coordinator, nproc, rank)
        else:
            init_distributed()
        nproc, rank = dist.get_world_size(), dist.get_rank()
        device = rank_device()
        try:
            results = run(device, rank, nproc, args.resnet_batch)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                np.savez(os.path.join(args.out, "rank%d.npz" % rank),
                         **results)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    print("WORKER_%d_OK" % rank, flush=True)


if __name__ == "__main__":
    main()
