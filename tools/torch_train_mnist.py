"""LeNet on MNIST via the Module API — the reference's canonical first
example (reference: example/image-classification/train_mnist.py), run
on mxnet_tpu_torch: a copy of example/image_classification/train_mnist.py
with its imports swapped, `--cpu` choosing the CPU context (the card
otherwise), and the package's generators seeded beside numpy's: the JAX
package draws the initial weights from a fixed default key, so its
example starts from the same weights every run, while this package's
generators start from fresh entropy unless seeded. LeNet under
Uniform(0.01) learns from some initial weights and not from others in
both packages alike, so an unseeded run would pass its assert on some
runs only.

Runs on real MNIST if the idx files are under --data-dir, otherwise on
synthetic data (the reference's `--benchmark 1` random-data mode,
example/image-classification/common/fit.py).

Usage: python tools/torch_train_mnist.py [--epochs 3] [--batch-size 64]
[--cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))  # run from a source checkout

import numpy as np


def lenet(num_classes=10):
    import mxnet_tpu_torch as mx
    data = mx.sym.var("data")
    c1 = mx.sym.Convolution(data, kernel=(5, 5), num_filter=20)
    a1 = mx.sym.Activation(c1, act_type="tanh")
    p1 = mx.sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = mx.sym.Convolution(p1, kernel=(5, 5), num_filter=50)
    a2 = mx.sym.Activation(c2, act_type="tanh")
    p2 = mx.sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f = mx.sym.Flatten(p2)
    fc1 = mx.sym.FullyConnected(f, num_hidden=500)
    a3 = mx.sym.Activation(fc1, act_type="tanh")
    fc2 = mx.sym.FullyConnected(a3, num_hidden=num_classes)
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def get_data(args):
    import mxnet_tpu_torch as mx
    try:
        from mxnet_tpu_torch.gluon.data.vision import MNIST
        train = MNIST(root=args.data_dir, train=True)
        val = MNIST(root=args.data_dir, train=False)
        xt = train._data.asnumpy().transpose(0, 3, 1, 2) / 255.0
        xv = val._data.asnumpy().transpose(0, 3, 1, 2) / 255.0
        yt, yv = train._label, val._label
        print("using real MNIST from", args.data_dir)
    except RuntimeError:
        print("MNIST files not found; using synthetic data "
              "(--benchmark mode)")
        rng = np.random.RandomState(0)
        # learnable stand-in: 10 spatial pattern classes (bars /
        # checkers / blobs), shift-jittered + noise
        n = 2400
        yt = rng.randint(0, 10, n)
        xt = np.zeros((n, 1, 28, 28), "float32")
        xs = np.arange(28)
        for i in range(n):
            c = int(yt[i])
            if c < 4:
                ang = c * np.pi / 4
                g = np.cos(ang) * xs[None, :] + np.sin(ang) * xs[:, None]
                img = (np.sin(2 * np.pi * g / 6) > 0).astype("float32")
            elif c < 7:
                k = [2, 4, 7][c - 4]
                img = ((xs[None, :] // k + xs[:, None] // k) % 2
                       ).astype("float32")
            else:
                r = [4, 8, 12][c - 7]
                cx, cy = rng.randint(9, 19, 2)
                d2 = (xs[None, :] - cx) ** 2 + (xs[:, None] - cy) ** 2
                img = (d2 < r * r).astype("float32")
            sh = rng.randint(-3, 4, 2)
            img = np.roll(np.roll(img, sh[0], 0), sh[1], 1)
            xt[i, 0] = img + rng.randn(28, 28) * 0.25
        yt = yt.astype("float32")
        xv, yv = xt[:500], yt[:500]
    train_iter = mx.io.NDArrayIter(xt.astype("float32"), yt,
                                   args.batch_size, shuffle=True)
    val_iter = mx.io.NDArrayIter(xv.astype("float32"), yv,
                                 args.batch_size)
    return train_iter, val_iter


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--data-dir",
                   default=os.path.join("~", ".mxnet", "datasets",
                                        "mnist"))
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the CUDA card otherwise)")
    args = p.parse_args()
    import mxnet_tpu_torch as mx
    ctx = mx.cpu() if args.cpu else mx.gpu(0)

    np.random.seed(1)   # NDArrayIter(shuffle=True) draws from the
    #                       global numpy RNG — pin it for reproducibility
    mx.random.seed(1)   # the initial weights, likewise
    train_iter, val_iter = get_data(args)
    mod = mx.mod.Module(lenet(), label_names=["softmax_label"], context=ctx)
    mod.fit(train_iter, eval_data=val_iter, num_epoch=args.epochs,
            optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            batch_end_callback=mx.callback.Speedometer(args.batch_size,
                                                       20))
    score = dict(mod.score(val_iter, "acc"))
    print("final accuracy:", score)
    assert score["accuracy"] > 0.8, "LeNet failed to learn: %s" % score
    print("MNIST_EXAMPLE_OK")


if __name__ == "__main__":
    main()
