"""Where an ImageRecordIter's host time goes, stage by stage and thread by
thread (the port's record pipeline, mxnet_tpu_torch/io_record.py).

Writes `--images` seeded synthetic JPEGs of `--height` x `--width` (the
records of chip_smoke.py's record_train phase) to a temporary .rec, then
prints one JSON line each:

- the host: CPU count, PIL's version and whether it decodes through
  libjpeg-turbo, and whether the native record library built (and with
  its JPEG decoder);
- one record's cost, stage by stage, on one thread, over the records:
  the decode (the iterator's own decoder) and each augmenter of the
  record_train chain (224 px random crop, mirror, cast, normalize);
- records a second through 1, 2, 4 and 8 Python threads of: the PIL
  decode alone, the augmenters alone (on one decoded image), the
  iterator's whole per-record function, and the ImageRecordIter itself
  (the loader alone: one epoch, no training).

Everything runs on the host; no card is needed.

Usage: python tools/torch_loader_probe.py [--images 512] [--height 375]
[--width 500] [--threads 1,2,4,8]
"""
import argparse
import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))  # run from a source checkout

import numpy as np

MEAN = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
            std_g=57.12, std_b=57.375)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--images", type=int, default=512)
    p.add_argument("--height", type=int, default=375)
    p.add_argument("--width", type=int, default=500)
    p.add_argument("--threads", default="1,2,4,8")
    return p.parse_args(argv)


def rate(fn, items, n):
    """Items a second of fn over `items`, split over n threads."""
    threads = [threading.Thread(target=lambda part=items[i::n]: [
        fn(x) for x in part]) for i in range(n)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return len(items) / (time.perf_counter() - t)


def main(argv=None):
    args = parse_args(argv)
    import io
    from PIL import Image, features
    import chip_smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _native, recordio
    threads = [int(t) for t in args.threads.split(",")]
    lib = _native.ensure_built()
    print(json.dumps(dict(
        host_cpus=os.cpu_count(), pil=Image.__version__,
        pil_libjpeg_turbo=features.check_feature("libjpeg_turbo"),
        native_library=lib is not None, native_jpeg=_native.has_jpeg())),
        flush=True)
    tmp = tempfile.mkdtemp(prefix="loader_probe_")
    path = os.path.join(tmp, "probe.rec")
    try:
        chip_smoke.write_records(path, args.images, args.height, args.width,
                                 0, 1000, 90)
        reader = recordio.MXRecordIO(path, "r")
        raws = []
        while True:
            raw = reader.read()
            if raw is None:
                break
            raws.append(raw)
        reader.close()
        kw = dict(path_imgrec=path, data_shape=(3, 224, 224), batch_size=128,
                  layout="NHWC", shuffle=True, rand_crop=True,
                  rand_mirror=True, round_batch=False, **MEAN)
        with mx.cpu():
            it = mx.io.ImageRecordIter(preprocess_threads=1, **kw)
            augs, decode_one = it._auglist, it._decode_one
            it.close()
            # one record's stages on one thread
            stages = {"decode": 0.0}
            for raw in raws:
                t = time.perf_counter()
                img = recordio._imdecode(recordio.unpack(raw)[1], 1)
                stages["decode"] += time.perf_counter() - t
                img = mx.image.array(img)
                for aug in augs:
                    t = time.perf_counter()
                    img = aug(img)
                    name = type(aug).__name__
                    stages[name] = stages.get(name, 0.0) + \
                        time.perf_counter() - t
            print(json.dumps({"ms_a_record_one_thread": {
                k: v / len(raws) * 1e3 for k, v in stages.items()}}),
                flush=True)
            first = np.asarray(Image.open(io.BytesIO(
                recordio.unpack(raws[0])[1])).convert("RGB"))

            def pil(raw):
                np.asarray(Image.open(io.BytesIO(
                    recordio.unpack(raw)[1])).convert("RGB"))

            def augment(_):
                img = mx.image.array(first.copy())
                for aug in augs:
                    img = aug(img)

            scaling = {}
            for name, fn in (("pil_decode", pil), ("augmenters", augment),
                             ("per_record", decode_one)):
                scaling[name] = {n: rate(fn, raws, n) for n in threads}
            loader = {}
            for n in threads:
                t = time.perf_counter()
                it = mx.io.ImageRecordIter(preprocess_threads=n, **kw)
                done = sum(b.data[0].shape[0] for b in it)
                loader[n] = done / (time.perf_counter() - t)
                it.close()
            scaling["image_record_iter"] = loader
            print(json.dumps({"records_a_second_by_threads": scaling}),
                  flush=True)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
