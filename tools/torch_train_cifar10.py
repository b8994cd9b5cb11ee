"""ResNet on CIFAR-10 with Gluon (reference: example/gluon/image_classification.py).

Real CIFAR-10 if the binary batches are under --data-dir, else synthetic.

Usage: python train_cifar10.py [--model resnet20ish] [--epochs 2] [--cpu]

This is example/gluon/train_cifar10.py run through the PyTorch/CUDA port,
mxnet_tpu_torch: the imports are the only change, and --cpu selects the
CPU as the default context where the original selects JAX's CPU platform.
It trains on the CUDA card by default.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))  # run from a source checkout

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet18_v1")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--data-dir",
                   default=os.path.join("~", ".mxnet", "datasets",
                                        "cifar10"))
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--hybridize", action="store_true", default=True)
    args = p.parse_args()
    import mxnet_tpu_torch as mx
    if args.cpu:
        mx.cpu().__enter__()
    from mxnet_tpu_torch import gluon, autograd
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.model_zoo import vision

    try:
        from mxnet_tpu_torch.gluon.data.vision import CIFAR10
        train = CIFAR10(root=args.data_dir, train=True)
        x = train._data.asnumpy().transpose(0, 3, 1, 2) / 255.0
        y = train._label
        print("using real CIFAR-10")
    except RuntimeError:
        print("CIFAR-10 not found; synthetic data")
        # learnable stand-in: class = (spatial pattern, color channel)
        rng = np.random.RandomState(0)
        n = 2048
        y = rng.randint(0, 10, n)
        x = np.zeros((n, 3, 32, 32), "float32")
        xs = np.arange(32)
        for i in range(n):
            c = y[i]
            ang = (c % 5) * np.pi / 5
            g = np.cos(ang) * xs[None, :] + np.sin(ang) * xs[:, None]
            pat = (np.sin(2 * np.pi * g / 6) > 0).astype("float32")
            x[i, c // 5] = pat
            x[i] += rng.randn(3, 32, 32) * 0.15
        y = y.astype("float32")

    loader = DataLoader(ArrayDataset(x.astype("float32"),
                                     y.astype("float32")),
                        batch_size=args.batch_size, shuffle=True,
                        last_batch="discard")
    net = vision.get_model(args.model, classes=10)
    net.initialize(mx.initializer.Xavier())
    if args.hybridize:
        net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": args.lr, "momentum": 0.9,
                             "wd": 1e-4})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for epoch in range(args.epochs):
        total, correct, lsum, n = 0, 0, 0.0, 0
        for xb, yb in loader:
            with autograd.record():
                out = net(xb)
                loss = loss_fn(out, yb)
            loss.backward()
            trainer.step(xb.shape[0])
            lsum += float(loss.mean().asscalar())
            n += 1
            pred = out.argmax(axis=1).asnumpy()
            correct += (pred == yb.asnumpy()).sum()
            total += xb.shape[0]
        acc = correct / total
        print("epoch %d loss %.4f acc %.3f" % (epoch, lsum / n, acc))
        if epoch == 0:
            first_acc = acc
    assert acc >= first_acc and acc > 0.25, \
        "no learning signal: acc %.3f (epoch0 %.3f)" % (acc, first_acc)
    print("CIFAR_EXAMPLE_OK")


if __name__ == "__main__":
    main()
