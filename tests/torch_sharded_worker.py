"""One rank of a torch.distributed gang training the port's
`ShardedTrainer` over a mesh that spans the gang (and the port's
`TrainerCheckpoint` across world sizes). It imports torch and the port
only; the JAX oracles run in the tests that start it.

    python tests/torch_sharded_worker.py COORDINATOR NPROC RANK \
        --mode MODE --inputs FILE --out DIR
    python tools/launch.py -n 4 python tests/torch_sharded_worker.py ...

Each rank runs on the CPU over gloo unless ``--device cuda`` puts it on
``cuda:(rank % cards)`` (``MXTPU_DIST_BACKEND=gloo`` lets two ranks share
a card; the trainer then runs eagerly, ``MXTPU_CUDA_GRAPH=0``). Every
rank is given the same global batches and the same weights (``--inputs``,
a `torch.save` of {case: {"weights": {block path: tensor}, ...}} that the
test wrote from the JAX nets); it writes what it computed to
``DIR/rank<r>.pt`` and prints ``WORKER_<r>_OK``.

Modes:

- ``parity``: the cases of JAX's tests/test_parallel.py over dp (see
  `CASES`), the mesh helpers, a Dropout net's masks, the refusals, and
  `gluon.Trainer`'s fused step with ``MXTPU_ZERO1=1`` (then one staged
  step);
- ``ckpt_save``: an Adam MLP (3 steps) and a compressed SGD MLP (4
  steps) saved with `TrainerCheckpoint` at steps 3 and 4;
- ``ckpt_restore``: both restored onto this (smaller) world, a resumed
  and an oracle trainer each, stepped on;
- ``ckpt_torn``: step 1 saved, then step 2 saved while the chaos site
  ``checkpoint.commit`` kills rank 1 (``MXTPU_CHAOS_RANK_1``): rank 0's
  commit barrier gives up (``MXTPU_BARRIER_TIMEOUT_S``), leaving step 2
  without its manifest;
- ``chip_small``: the narrow NHWC ResNet at global batch 16 on the card
  (chip_smoke.py's ``dist_sharded_small``).
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NPROC = 4
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
COMP = {"type": "2bit", "threshold": 0.1}
RESNET = dict(layers=[1, 1], channels=[16, 32, 64], classes=10, img=32,
              batch=16, steps=3)
DROPOUT_STEPS = 2
FUSED_STEPS = 3
FUSED = dict(batch=4, in_units=10, hidden=16, classes=4)

# case: (net, optimizer, optimizer params, trainer arguments, steps,
# batch shapes (x, y) and number of classes)
CASES = {
    # JAX tests/test_parallel.py:26 (at dp=4 and 60 steps)
    "convergence": ("dense1", "sgd", {"learning_rate": 0.2,
                                      "momentum": 0.9}, {}, 60),
    # :46, against one device and the JAX dp=4 mesh
    "single": ("dense1_zeros", "sgd", {"learning_rate": 0.1}, {}, 5),
    # :171: step_many(5) against 5 steps, a BatchNorm net
    "convbn": ("convbn", "sgd", {"learning_rate": 0.1, "momentum": 0.9},
               {}, 5),
    # :203: ZeRO-1 against replicated, Adam
    "zero1": ("mlp32", "adam", {"learning_rate": 0.01},
              {"shard_optimizer_state": True}, 3),
    "zero1_rep": ("mlp32", "adam", {"learning_rate": 0.01}, {}, 3),
    # ZeRO-1 under SGD, through the kernel's plan over blocks of rows
    "zero1_sgd": ("mlp32", "sgd", SGD, {"shard_optimizer_state": True}, 3),
    # :280 and :340: TNC data, rank-1 labels, with and without compression
    "batch_axis1": ("mean", "sgd", {"learning_rate": 0.1},
                    {"batch_axis": 1}, 3),
    "batch_axis1_comp": ("mean", "sgd", {"learning_rate": 0.1},
                         {"batch_axis": 1, "gradient_compression": COMP},
                         3),
    # :308: the compressed step in predict mode, a BatchNorm net
    "comp_predict": ("bnpred", "sgd", {"learning_rate": 0.1},
                     {"aux_mode": "predict", "gradient_compression": COMP},
                     3),
    # the compressed step in train mode: each rank's own statistics,
    # the moving statistics pmean'd
    "comp_train": ("bnpred", "sgd", {"learning_rate": 0.1},
                   {"gradient_compression": COMP}, 3),
    # global-batch BatchNorm through conv1x1_bn_nhwc's plain path
    "resnet": ("resnet", "sgd", SGD, {}, RESNET["steps"]),
}


# -- the data and the nets, the same for every caller ------------------------
def batch(case):
    """(x, y) of a case: the global batch, float32."""
    net = CASES[case][0]
    rng = np.random.RandomState(sum(map(ord, net)))
    if net.startswith("dense1"):
        n, c = (64, 10) if net == "dense1" else (16, 6)
        x = rng.randn(n, c).astype(np.float32)
        w = rng.randn(c, 1).astype(np.float32)
        y = x @ w if net == "dense1" else \
            (x.sum(1, keepdims=True) > 0).astype(np.float32)
        return x, y
    if net == "convbn":
        return (rng.randn(16, 3, 8, 8).astype(np.float32),
                (np.arange(16) % 10).astype(np.float32))
    if net == "mlp32":
        return (rng.randn(16, 16).astype(np.float32),
                (np.arange(16) % 10).astype(np.float32))
    if net == "mean":
        return (rng.randn(5, 16, 4).astype(np.float32),
                (np.arange(16) % 10).astype(np.float32))
    if net in ("bnpred", "dropout"):
        return (rng.randn(16, 6).astype(np.float32),
                (np.arange(16) % 4).astype(np.float32))
    if net == "resnet":
        b, i = RESNET["batch"], RESNET["img"]
        return (rng.randn(b, i, i, 3).astype(np.float32),
                (np.arange(b) % RESNET["classes"]).astype(np.float32))
    raise KeyError(net)


def loss_of(gluon, net):
    """The case's loss in either package (L2 for the regressions)."""
    if net.startswith("dense1"):
        return gluon.loss.L2Loss()
    return gluon.loss.SoftmaxCrossEntropyLoss()


def build(gluon, net):
    """The case's net from `gluon` (either package's), uninitialized;
    every shape is given, so no forward is needed to make it."""
    nn = gluon.nn
    if net == "dense1":
        return nn.Dense(1, in_units=10)
    if net == "dense1_zeros":
        return nn.Dense(1, in_units=6, weight_initializer="zeros",
                        bias_initializer="zeros")
    m = nn.HybridSequential()
    if net == "convbn":
        m.add(nn.Conv2D(4, 3, padding=1, in_channels=3),
              nn.BatchNorm(in_channels=4), nn.Activation("relu"),
              nn.GlobalAvgPool2D(), nn.Dense(10, in_units=4))
    elif net == "mlp32":
        m.add(nn.Dense(32, activation="relu", in_units=16),
              nn.Dense(10, in_units=32))
    elif net == "bnpred":
        m.add(nn.Dense(8, in_units=6), nn.BatchNorm(in_channels=8),
              nn.Dense(4, in_units=8))
    elif net == "dropout":
        m.add(nn.Dense(8, activation="relu", in_units=6), nn.Dropout(0.5),
              nn.Dense(4, in_units=8))
    elif net == "fused_mlp":
        m.add(nn.Dense(FUSED["hidden"], activation="relu",
                       in_units=FUSED["in_units"]),
              nn.Dense(FUSED["classes"], in_units=FUSED["hidden"]))
    elif net == "ckpt":
        m.add(nn.Dense(16, activation="relu", in_units=8),
              nn.Dense(10, in_units=16))
    elif net == "mean":
        class Mean(gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.out = nn.Dense(10, in_units=4)

            def hybrid_forward(self, F, x):
                return self.out(F.mean(x, axis=0))
        return Mean()
    else:
        raise KeyError(net)
    return m


def build_resnet(vision):
    return vision.ResNetV1(vision.BottleneckV1, RESNET["layers"],
                           RESNET["channels"], classes=RESNET["classes"],
                           layout="NHWC")


def fused_batch(step, rank):
    """Rank `rank`'s own batch at `step` for the gluon.Trainer case."""
    rng = np.random.RandomState(3000 + 10 * step + rank)
    return (rng.randn(FUSED["batch"], FUSED["in_units"]).astype(np.float32),
            rng.randint(0, FUSED["classes"], FUSED["batch"])
            .astype(np.float32))


CKPT = dict(adam_steps=3, comp_steps=4, resume_steps=2, lr=0.01,
            comp_lr=0.05, comp=dict(type="2bit", threshold=0.05))


def ckpt_batch():
    """JAX tests/test_trainer_checkpoint.py's `_batch` at seed 0."""
    rng = np.random.RandomState(0)
    return (rng.randn(16, 8).astype(np.float32),
            (np.arange(16) % 10).astype(np.float32))


# -- the port's side -----------------------------------------------------------
def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def _port_net(mx, net, weights, device):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    m = build_resnet(vision) if net == "resnet" else build(gluon, net)
    m.initialize(ctx=mx.cpu() if device.type == "cpu" else
                 mx.gpu(device.index))
    m.load_parameters({k: v.to(device) for k, v in weights.items()})
    return m


def _trainer(mx, case, weights, device, **extra):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import ShardedTrainer
    net, opt, hp, kw, _ = CASES[case]
    m = _port_net(mx, net, weights, device)
    return ShardedTrainer(m, loss_of(gluon, net), opt, dict(hp),
                          **dict(kw, **extra))


def by_path(st, tree):
    """`tree` (a trainer's state by Gluon name, nested for Adam) keyed by
    the parameters' block paths, which both packages' nets share."""
    if isinstance(tree, dict):
        return {st._paths.get(k, k): by_path(st, v) for k, v in tree.items()}
    return tree


def _state(st):
    return by_path(st, {"params": _host(st.params), "aux": _host(st.aux),
                        "opt_state": _host(st.opt_state)})


def run_case(mx, case, inputs, device):
    """Losses and state after the case's steps (plus what the case
    checks on its own)."""
    x, y = batch(case)
    st = _trainer(mx, case, inputs[CASES[case][0]], device)
    steps = CASES[case][4]
    out = {}
    if case == "convbn":
        many = _trainer(mx, case, inputs["convbn"], device)
        out["many"] = many.step_many(x, y, n_steps=steps).cpu()
        out["many_count"] = many._step_count
        out["many_state"] = _state(many)
    if case == "resnet":
        from mxnet_tpu_torch.ops import conv1x1_bn
        calls = []
        apply = conv1x1_bn.Conv1x1BNStats.apply

        def counted(*a):
            calls.append(1)
            return apply(*a)
        conv1x1_bn.Conv1x1BNStats.apply = counted
    try:
        out["losses"] = [float(st.step(x, y)) for _ in range(steps)]
    finally:
        if case == "resnet":
            conv1x1_bn.Conv1x1BNStats.apply = apply
            out["conv1x1_bn_calls"] = len(calls)
    out.update(_state(st))
    if st._shard_opt:
        out["local_opt_rows"] = by_path(st, {
            k: tuple(v.shape) for k, v in (
                st._opt_state["m"] if "m" in st._opt_state
                else st._opt_state).items()})
        out["zero_keys"] = [st._paths[k] for k in st._zero]
    if st._gc is not None:
        out["residual"] = by_path(st, _host(st._gc_residuals))
    return out


def mesh_checks(mx, rank, nproc):
    """The mesh across the gang and its helpers."""
    from mxnet_tpu_torch.parallel import mesh as M
    P = M.PartitionSpec
    out = {}
    m = M.make_mesh({"dp": 2, "tp": -1})
    out["shape"] = dict(m.shape)
    out["index"] = (m.axis_index("dp"), m.axis_index("tp"))
    out["device"] = str(m.device)
    whole = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    out["put_dp"] = M.put_sharded(whole, M.shard_on(m, "dp")).clone()
    out["put_both"] = M.put_sharded(
        whole, M.NamedSharding(m, P(("dp", "tp")))).clone()
    d = M.make_mesh()
    out["dp_shape"] = dict(d.shape)
    v = torch.full((3,), float(rank + 1))
    out["psum"] = M.psum(v, "dp", d)
    out["pmean"] = M.pmean(v, "dp", d)
    out["all_gather"] = M.all_gather(v, "dp", d)
    out["all_gather_tiled"] = M.all_gather(v, "dp", d, tiled=True)
    out["tp_psum"] = M.psum(v, "tp", m)
    # pmean's backward is the pmean of the incoming gradient
    a = torch.full((2,), float(rank + 1), requires_grad=True)
    (M.pmean(a, "dp", d) * (rank + 1)).sum().backward()
    out["pmean_grad"] = a.grad.clone()

    def f(x, w):
        # x: this rank's rows; w: whole; returns (P(), P("dp")) outputs
        return M.psum((x @ w).sum(0), "dp"), x * M.axis_index("dp")
    g = M.shard_map_compat(f, d, (P("dp"), P()), (P(), P("dp")))
    s, local = g(whole, torch.ones(3, 2))
    out["smap_sum"], out["smap_local"] = s, local
    return out


def dropout_masks(mx, inputs, device):
    """Each rank's Dropout masks over two steps (the zero pattern after
    the Dropout, recorded by a forward hook)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import ShardedTrainer
    mx.random.seed(11)          # every rank alike: the trainer folds ranks
    m = _port_net(mx, "dropout", inputs["dropout"], device)
    seen = []
    drop = [b for b in m._modules.values()
            if isinstance(b, gluon.nn.Dropout)][0]
    drop.register_forward_hook(
        lambda mod, args, out: seen.append(
            (out._data if hasattr(out, "_data") else out) == 0))
    st = ShardedTrainer(m, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        {"learning_rate": 0.1})
    x, y = batch("comp_predict")
    losses = [float(st.step(x, y)) for _ in range(DROPOUT_STEPS)]
    return {"masks": torch.stack([s.detach().cpu() for s in seen]),
            "losses": losses}


def refusals(mx, inputs, device):
    """Each refusal's message (None where nothing raised)."""
    from mxnet_tpu_torch import MXNetError, gluon
    from mxnet_tpu_torch.parallel import ShardedTrainer, mesh as M
    from mxnet_tpu_torch.parallel import data_parallel as dp
    out = {}
    net = _port_net(mx, "mlp32", inputs["mlp32"], device)
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    tries = {
        "tp": lambda: ShardedTrainer(
            net, loss, "sgd", mesh=M.make_mesh({"dp": 2, "tp": 2}),
            param_rules=[(r"dense0_weight", M.PartitionSpec("tp"))]),
        "sp": lambda: ShardedTrainer(
            net, loss, "sgd", mesh=M.make_mesh({"dp": 2, "sp": 2}),
            input_specs={"data": ("dp", "sp")}),
        "zero1_compression": lambda: ShardedTrainer(
            net, loss, "sgd", gradient_compression=COMP,
            shard_optimizer_state=True),
        "graph_over_gloo": lambda: dp.refuse_capture_over(
            M.make_mesh(), "dp"),
        "step_many_compressed": lambda: ShardedTrainer(
            net, loss, "sgd", gradient_compression=COMP).step_many(
                *batch("zero1"), n_steps=2),
    }
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except MXNetError as err:
            out[name] = str(err)
    # a tp axis of size 1 shards nothing: accepted
    ShardedTrainer(net, loss, "sgd", mesh=M.make_mesh({"dp": 4, "tp": 1}),
                   param_rules=[(r"dense0_weight", M.PartitionSpec("tp"))])
    return out


def fused_zero1(mx, rank, nproc, inputs, device):
    """gluon.Trainer over 'dist_sync', fused step, each rank its own
    batch, SGD then Adam: with MXTPU_ZERO1=1 and without (replicated)."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.parallel.fused_step import ZERO1_SHARD_PARAMS
    out = {}
    for opt, hp in (("sgd", SGD), ("adam", {"learning_rate": 0.01,
                                            "wd": 1e-4})):
        for zero1 in ("1", "0"):
            os.environ["MXTPU_ZERO1"] = zero1
            m = _port_net(mx, "fused_mlp", inputs["fused_mlp"], device)
            tr = gluon.Trainer(m.collect_params(), opt, dict(hp),
                               kvstore="dist_sync")
            tag = "%s_zero%s" % (opt, zero1)
            # FUSED_STEPS fused steps, then one staged step (which takes
            # the ZeRO-1 blocks back into the per-key states first)
            for s in range(FUSED_STEPS + 1):
                if s == FUSED_STEPS:
                    step = tr._updaters[0]._fused_step_owner
                    out[tag + "_carried"] = len(step._zero_flats)
                    os.environ["MXTPU_FUSED_STEP"] = "0"
                x, y = fused_batch(s, rank)
                with autograd.record():
                    loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                        m(torch.from_numpy(x).to(device)),
                        torch.from_numpy(y).to(device))
                loss.backward()
                tr.step(FUSED["batch"] * nproc)
            os.environ.pop("MXTPU_FUSED_STEP")
            if zero1 == "1":
                out[tag + "_gauge"] = ZERO1_SHARD_PARAMS.get()
            # the states, whole (the ZeRO-1 blocks all-gathered)
            states = tr._updaters[0].get_states(dump_optimizer=False)
            out[tag + "_states_bytes"] = len(states)
            out[tag] = {k: p.data().detach().cpu().clone()
                        for k, p in zip(
                            range(len(m.collect_params())),
                            m.collect_params().values())}
            flat = []
            for st in tr._updaters[0].states.values():
                stack = [st]
                while stack:
                    s = stack.pop()
                    if isinstance(s, (list, tuple)):
                        stack.extend(s)
                    elif isinstance(s, torch.Tensor):
                        flat.append(s.detach().cpu().clone())
            out[tag + "_state"] = flat
    os.environ.pop("MXTPU_ZERO1", None)
    return out


def parity(mx, rank, nproc, inputs, device):
    results = {"mesh": mesh_checks(mx, rank, nproc)}
    for case in CASES:
        results[case] = run_case(mx, case, inputs, device)
    results["dropout"] = dropout_masks(mx, inputs, device)
    results["refusals"] = refusals(mx, inputs, device)
    results["fused"] = fused_zero1(mx, rank, nproc, inputs, device)
    return results


def _ckpt_trainer(mx, inputs, device, compressed, **kw):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import ShardedTrainer
    m = _port_net(mx, "ckpt", inputs["ckpt"], device)
    if compressed:
        return ShardedTrainer(m, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                              {"learning_rate": CKPT["comp_lr"]},
                              gradient_compression=CKPT["comp"], **kw)
    return ShardedTrainer(m, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                          {"learning_rate": CKPT["lr"]}, **kw)


def checkpoints(mx, mode, inputs, device, ckdir):
    from mxnet_tpu_torch.parallel.checkpoint import TrainerCheckpoint
    x, y = ckpt_batch()
    out = {}
    if mode == "ckpt_save":
        big = _ckpt_trainer(mx, inputs, device, False)
        out["losses"] = [float(big.step(x, y))
                         for _ in range(CKPT["adam_steps"])]
        with TrainerCheckpoint(os.path.join(ckdir, "adam")) as ck:
            ck.save(CKPT["adam_steps"], big, wait=True)
        comp = _ckpt_trainer(mx, inputs, device, True)
        out["comp_losses"] = [float(comp.step(x, y))
                              for _ in range(CKPT["comp_steps"])]
        out["residual"] = by_path(comp, _host(comp._gc_residuals))
        with TrainerCheckpoint(os.path.join(ckdir, "comp")) as ck:
            ck.save(CKPT["comp_steps"], comp, wait=True)
        out.update(_state(big))
    elif mode == "ckpt_restore":
        with TrainerCheckpoint(os.path.join(ckdir, "adam")) as ck:
            small = _ckpt_trainer(mx, inputs, device, False)
            out["restored"] = ck.restore_latest(small)
            out["resumed"] = [float(small.step(x, y))
                              for _ in range(CKPT["resume_steps"])]
            oracle = _ckpt_trainer(mx, inputs, device, False)
            ck.restore_latest(oracle)
            out["oracle"] = [float(oracle.step(x, y))
                             for _ in range(CKPT["resume_steps"])]
            # onto another layout: ZeRO-1's blocks of rows over 2 ranks
            zero = _ckpt_trainer(mx, inputs, device, False,
                                 shard_optimizer_state=True)
            out["zero_restored"] = ck.restore(CKPT["adam_steps"], zero)
            out["zero_rows"] = {zero._paths[k]: tuple(v.shape)
                                for k, v in zero._opt_state["m"].items()}
            out["zero_at_restore"] = _state(zero)
            out["zero_resumed"] = [float(zero.step(x, y))
                                   for _ in range(CKPT["resume_steps"])]
        out["resumed_state"] = _state(small)
        out["oracle_state"] = _state(oracle)
        with TrainerCheckpoint(os.path.join(ckdir, "comp")) as ck:
            comp = _ckpt_trainer(mx, inputs, device, True)
            out["comp_restored"] = ck.restore_latest(comp)
            out["comp_residual"] = by_path(comp, _host(comp._gc_residuals))
            out["comp_losses"] = [float(comp.step(x, y)) for _ in range(3)]
    elif mode == "ckpt_torn":
        st = _ckpt_trainer(mx, inputs, device, False)
        with TrainerCheckpoint(os.path.join(ckdir, "torn")) as ck:
            st.step(x, y)
            ck.save(1, st)
            out["saved_1"] = True
            st.step(x, y)
            ck.save(2, st)       # rank 1 dies at checkpoint.commit
    return out


def chip_small(mx, rank, nproc, inputs, device):
    """The narrow NHWC ResNet at global batch 16 (fp32, eager): the
    global-batch trainer, ZeRO-1, compression, a checkpoint saved here
    for a one-rank restore, and the graph-mode refusal over gloo."""
    from mxnet_tpu_torch import MXNetError, ops
    from mxnet_tpu_torch.parallel.checkpoint import TrainerCheckpoint
    x, y = batch("resnet")
    out = {}
    for tag, extra in (("plain", {}), ("zero1", {"shard_optimizer_state":
                                                  True}),
                       ("comp", {"gradient_compression": COMP})):
        st = _trainer(mx, "resnet", inputs["resnet"], device, **extra)
        ops.reset_launch_counts()
        out[tag + "_losses"] = [float(st.step(x, y))
                                for _ in range(RESNET["steps"])]
        out[tag + "_launches"] = ops.launch_counts()
        out[tag] = _state(st)
        if tag == "plain":
            with TrainerCheckpoint(inputs["ckpt_dir"]) as ck:
                ck.save(st._step_count, st, wait=True)
            out["after_save"] = [float(st.step(x, y)) for _ in range(2)]
    os.environ["MXTPU_CUDA_GRAPH"] = "1"
    try:
        _trainer(mx, "resnet", inputs["resnet"], device)
        out["graph_over_gloo"] = None
    except MXNetError as err:
        out["graph_over_gloo"] = str(err)
    finally:
        os.environ["MXTPU_CUDA_GRAPH"] = "0"
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rendezvous", nargs="*",
                    help="COORDINATOR NPROC RANK (else the launcher's env)")
    ap.add_argument("--mode", required=True,
                    choices=("parity", "ckpt_save", "ckpt_restore",
                             "ckpt_torn", "chip_small"))
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel.kvstore_dist import (init_distributed,
                                                       rank_device)
    inputs = torch.load(args.inputs)
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)
    with ctx:
        if args.rendezvous:
            init_distributed(args.rendezvous[0], int(args.rendezvous[1]),
                             int(args.rendezvous[2]))
        else:
            init_distributed()
        nproc, rank = dist.get_world_size(), dist.get_rank()
        device = rank_device()
        try:
            if args.mode == "parity":
                results = parity(mx, rank, nproc, inputs, device)
            elif args.mode == "chip_small":
                results = chip_small(mx, rank, nproc, inputs, device)
            else:
                results = checkpoints(mx, args.mode, inputs, device,
                                      inputs["ckpt_dir"])
            os.makedirs(args.out, exist_ok=True)
            torch.save(results, os.path.join(args.out, "rank%d.pt" % rank))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    print("WORKER_%d_OK" % rank, flush=True)


if __name__ == "__main__":
    main()
