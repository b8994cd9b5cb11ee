"""Why a narrow MobileNet's SGD steps on a CUDA card part from the CPU's.

    python3 tools/torch_twin_probe.py [--img 64] [--batch 4] [--lr 0.1]

Needs one CUDA card (the first call builds the kernels). Builds
mobilenet0.25 (NHWC, Xavier, seed 3) on the card and on the CPU from
the same weights and seeded data, TF32 off, and prints one JSON line for
each of:

- ``float64``: both nets cast to float64 (no kernel takes float64, so
  the 1x1 convolutions and BatchNorms run apart and the update is plain
  MXNet-form momentum SGD in this script): the loss, gradient and
  weight differences after each of two compounding steps. The two
  devices compute the same function when these sit at float64 rounding.
- ``float32`` with cuDNN on and off: two compounding steps through
  ``gluon.Trainer`` (the kernels on the card). The inputs of every ReLU
  in the first forward, card against CPU: how many lie on the other
  side of 0 (``flips``), the smallest |x| among them and the largest
  card-vs-CPU difference of those inputs; the first step's largest
  gradient departure and where; the losses and weight differences after
  each step; the first update's largest size over the weight's own.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import mxnet_tpu_torch as mx                                  # noqa: E402
from mxnet_tpu_torch import autograd                          # noqa: E402
from mxnet_tpu_torch.gluon import nn                          # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import get_model  # noqa: E402

MOMENTUM, WD = 0.9, 1e-4


def build(ctx, dtype, x, y, lr, trainer):
    with ctx:
        mx.random.seed(3)
        net = get_model("mobilenet0.25", classes=10, layout="NHWC")
        net.initialize(mx.init.Xavier())
        net(x[:1].to(ctx.torch_device))     # deferred shapes: draw now
        if dtype != torch.float32:
            net.cast(str(dtype).replace("torch.", ""))
        tr = mx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": lr, "momentum": MOMENTUM, "wd": WD}) \
            if trainer else None
    relu_in = []
    for blk in net._blocks():
        if isinstance(blk, nn.Activation):
            blk.register_forward_pre_hook(
                lambda b, args: relu_in.append(
                    args[0].astorch().detach().double().cpu()))
    return dict(ctx=ctx, net=net, tr=tr, relu_in=relu_in, moms={},
                x=x.to(ctx.torch_device, dtype), y=y.to(ctx.torch_device))


def params(side):
    return side["net"]._collect_params_with_prefix()


def step(side, lr):
    """One record/backward/update; returns (loss, {name: gradient})."""
    side["relu_in"].clear()
    with side["ctx"]:
        with autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                side["net"](side["x"]), side["y"])
        loss.backward()
        grads = {k: p.grad().detach().double().cpu().clone()
                 for k, p in params(side).items() if p.grad_req != "null"}
        batch = side["x"].shape[0]
        if side["tr"] is not None:
            side["tr"].step(batch)
        else:
            # MXNet's SGD: mom = momentum mom - lr (grad / batch + wd w);
            # w += mom
            with torch.no_grad():
                for k, p in params(side).items():
                    if p.grad_req == "null":
                        continue
                    w = p.data()
                    m = side["moms"].setdefault(k, torch.zeros_like(w))
                    m.mul_(MOMENTUM).sub_(lr * (p.grad() / batch + WD * w))
                    w.add_(m)
    return loss.astorch().detach().double().mean().item(), grads


def weights(side):
    return {k: p.data().detach().double().cpu().clone()
            for k, p in params(side).items()}


def max_diff(a, b):
    return max((a[k] - b[k]).abs().max().item() for k in b)


def compare(dtype, img, batch, lr, cudnn=True):
    torch.backends.cudnn.enabled = cudnn
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(batch, img, img, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, batch).astype(np.float32))
    fused = dtype == torch.float32
    card = build(mx.gpu(0), dtype, x, y, lr, fused)
    cpu = build(mx.cpu(), dtype, x, y, lr, fused)
    w0 = weights(cpu)
    rec = dict(dtype=str(dtype).replace("torch.", ""), cudnn=cudnn, img=img,
               batch=batch, lr=lr, loss_card=[], loss_cpu=[],
               loss_abs_err=[], grad_abs_err=[], weight_abs_err=[])
    for k in range(2):
        lc, gc = step(card, lr)
        lh, gh = step(cpu, lr)
        if k == 0:
            worst = max(gh, key=lambda n: (gc[n] - gh[n]).abs().max())
            rec["first_grad_worst"] = dict(
                param=worst, abs_err=(gc[worst] - gh[worst]).abs().max()
                .item(), max_abs=gh[worst].abs().max().item())
            flips, near, in_err = 0, [], 0.0
            for i, (a, b) in enumerate(zip(card["relu_in"],
                                           cpu["relu_in"])):
                side = (a > 0) != (b > 0)
                flips += int(side.sum())
                in_err = max(in_err, (a - b).abs().max().item())
                if side.any():
                    near.append(dict(relu=i, shape=list(b.shape),
                                     min_abs=b[side].abs().min().item(),
                                     input_abs_err=(a - b).abs().max()
                                     .item()))
            rec.update(relus=len(cpu["relu_in"]), flips=flips,
                       flipped=near, relu_input_abs_err=in_err)
            wc = weights(cpu)
            rec["first_update_over_weight"] = max(
                ((wc[n] - w0[n]).abs().max() / w0[n].abs().max()).item()
                for n in gh if w0[n].abs().max() > 0)
        rec["loss_card"].append(lc)
        rec["loss_cpu"].append(lh)
        rec["loss_abs_err"].append(abs(lc - lh))
        rec["grad_abs_err"].append(max_diff(gc, gh))
        rec["weight_abs_err"].append(max_diff(weights(card), weights(cpu)))
    torch.backends.cudnn.enabled = True
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.1)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_twin_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(compare(torch.float64, a.img, a.batch, a.lr)),
          flush=True)
    for cudnn in (True, False):
        print(json.dumps(compare(torch.float32, a.img, a.batch, a.lr,
                                 cudnn)), flush=True)


if __name__ == "__main__":
    main()
