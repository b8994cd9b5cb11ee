"""ImageNet-style training on record files through the PyTorch/CUDA port
(the counterpart of example/image_classification/train_imagenet.py, with
the same flags and the same composition; reference:
example/image-classification/train_imagenet.py + common/fit.py).

Input: a .rec file (with its .idx beside it, as im2rec writes them)
through the threaded `mx.io.ImageRecordIter` (shuffle, random crop and
mirror, `--preprocess-threads` decode workers), or `--benchmark 1` for
one synthetic batch repeated (common/fit.py's benchmark mode). The
batches go to `parallel.ShardedTrainer` (SGD, momentum 0.9, wd 1e-4 by
default; bf16 compute over fp32 master parameters; on the card its step
is one CUDA graph replay) through `ShardedTrainer.prefetched`, which
stages batch k+1 on the card while batch k trains. Weights start from
`convert.init_resnet_params(seed=0)` (Gluon's default initializer).

Runs on the CUDA card; `--cpu` runs on the CPU instead.

Usage:
  python tools/torch_train_imagenet.py --benchmark 1            # synthetic
  python tools/torch_train_imagenet.py --data-train train.rec   # records
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))  # run from a source checkout
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--network", default="resnet50_v1")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--image-shape", default="3,224,224")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--num-epochs", type=int, default=1)
    p.add_argument("--max-batches", type=int, default=0,
                   help="stop an epoch early (0 = full epoch)")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--data-train", default=None, help=".rec file")
    p.add_argument("--preprocess-threads", type=int, default=8)
    p.add_argument("--benchmark", type=int, default=0)
    p.add_argument("--layout", default="NHWC", choices=["NCHW", "NHWC"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.convert import init_resnet_params
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.parallel import ShardedTrainer

    device = "cpu" if args.cpu else "cuda"
    c, h, w = map(int, args.image_shape.split(","))
    nhwc = args.layout == "NHWC"
    net = getattr(vision, args.network)(classes=args.num_classes,
                                        layout=args.layout, device=device)
    init_resnet_params(net, seed=0)

    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    st = ShardedTrainer(
        net, loss, "sgd",
        {"learning_rate": args.lr, "momentum": args.momentum,
         "wd": args.wd},
        compute_dtype=None if args.dtype == "float32" else args.dtype,
        device=device)

    it = None
    if args.benchmark or not args.data_train:
        rng = np.random.RandomState(0)
        bshape = (args.batch_size, h, w, c) if nhwc \
            else (args.batch_size, c, h, w)
        x = rng.randn(*bshape).astype("float32")
        y = (rng.rand(args.batch_size) * args.num_classes).astype("f")
        batches = [(x, y)] * (args.max_batches or 50)

        def epoch_iter(epoch):
            return iter(batches)
    else:
        it = mx.io.ImageRecordIter(
            path_imgrec=args.data_train, data_shape=(c, h, w),
            batch_size=args.batch_size, shuffle=True, rand_crop=True,
            rand_mirror=True, layout=args.layout,
            preprocess_threads=args.preprocess_threads,
            round_batch=False)
        print("record reader: %s" % it.reader)

        def epoch_iter(epoch):
            if epoch:       # the iterator's first epoch started with it
                it.reset()
            return it

    for epoch in range(args.num_epochs):
        t0 = time.perf_counter()
        n, last = 0, None
        staged = st.prefetched(epoch_iter(epoch))
        try:
            for i, batch in enumerate(staged):
                last = st.step(*batch)
                n += args.batch_size
                if args.max_batches and i + 1 >= args.max_batches:
                    break
        finally:
            staged.close()
        loss_value = float(last)        # waits for the last step
        dt = time.perf_counter() - t0
        print("epoch %d: %.1f img/s, loss %.4f" % (epoch, n / dt, loss_value))
    if it is not None:
        print("decoders: %s" % dict(it.decoders))
        it.close()
    st.copy_params_to_net()
    return loss_value


if __name__ == "__main__":
    main()
