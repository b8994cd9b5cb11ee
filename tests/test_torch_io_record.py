"""Parity of the port's ImageRecordIter (mxnet_tpu_torch/io_record.py) with
the JAX package's, on the CPU, and the slice as a whole.

On the same records, with ``shuffle=True`` and one seed, the two
iterators give bit-identical batches, labels and pads: at 1 and 4
preprocess threads with deterministic augmenters (and at 1 thread with
the random crop and mirror under one `random.seed`), in NCHW and NHWC,
float32 and uint8, with and without `round_batch`, and under
`part_index`/`num_parts`. The corrupt-record budget skips and then fails
as JAX's does. The port's iterator names its reader and decoder, counts
its batches and samples its queue depth.

The slice: .rec -> ImageRecordIter (NHWC) -> one-device ShardedTrainer,
a narrow ResNetV1 at 32 px, b8, fp32, 2 steps, against JAX's
ImageRecordIter -> ShardedTrainer from the same weights (carried across
by `convert.gluon_params_from_jax`): losses and every state tensor
within 1e-5 relative to max(1, |tensor|), the tolerance
tests/test_torch_sharded_trainer.py holds the trainers to. And
`Module.fit` over an ImageRecordIter: the training metric within 1e-4
relative of JAX's Module, the parameters within 1e-5."""
import logging
import os
import random
import sys

import numpy as np
import jax
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _native as tnative, recordio as trio
from mxnet_tpu_torch.observability import registry

from torch_record_parity import (no_persistent_compile_cache,  # noqa: F401
                                 port_native_library, write_rec)

N, H, W = 23, 20, 18
TOL_REL = 1e-5      # the trainers' fp32 tolerance
LOSS_REL = 1e-4     # Module.fit's training metric


@pytest.fixture(autouse=True)
def _env(no_persistent_compile_cache, port_native_library):  # noqa: F811
    with tmx.cpu():
        yield


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return write_rec(trio, tmp_path_factory.mktemp("rec") / "data.rec", N,
                     h=H, w=W)


def _drain(mod, draw_seed=None, **kw):
    """[(data, label, pad)] of one epoch of `mod`'s ImageRecordIter; with
    `draw_seed` the global generators are seeded just before the iterator
    starts (its workers draw the random crops and flips)."""
    if draw_seed is not None:
        random.seed(draw_seed)
        np.random.seed(draw_seed)
    it = mod.io.ImageRecordIter(**kw)
    out = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]
    it.close()
    return out, it


def _equal(got, want):
    assert len(got) == len(want) > 0
    for (gx, gy, gp), (wx, wy, wp) in zip(got, want):
        assert gx.dtype == wx.dtype and gx.shape == wx.shape
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gp == wp


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("threads", [1, 4])
def test_batches_equal_jax(rec, threads, layout, dtype):
    kw = dict(path_imgrec=rec, data_shape=(3, 16, 14), batch_size=4,
              shuffle=True, seed=7, preprocess_threads=threads,
              layout=layout, dtype=dtype, mean_r=10.0, std_b=2.0
              if dtype == "float32" else 1.0)
    got, it = _drain(tmx, **kw)
    want, _ = _drain(jmx, **kw)
    _equal(got, want)
    assert got[-1][2] == 1            # 23 records, round_batch: one pad
    shape = (4, 3, 16, 14) if layout == "NCHW" else (4, 16, 14, 3)
    assert got[0][0].shape == shape and it.provide_data[0].shape == shape


@pytest.mark.parametrize("parts", [(0, 2), (1, 2), (2, 3)])
def test_part_index_and_round_batch_equal_jax(rec, parts):
    kw = dict(path_imgrec=rec, data_shape=(3, 16, 14), batch_size=3,
              preprocess_threads=2, round_batch=False, part_index=parts[0],
              num_parts=parts[1])
    got, _ = _drain(tmx, **kw)
    want, _ = _drain(jmx, **kw)
    _equal(got, want)
    labels = np.concatenate([y for _, y, _ in got]).astype(int)
    assert all(i % parts[1] == parts[0] for i in labels)


def test_random_crop_and_mirror_equal_jax_at_one_thread(rec):
    kw = dict(path_imgrec=rec, data_shape=(3, 12, 10), batch_size=4,
              shuffle=True, seed=3, rand_crop=True, rand_mirror=True,
              preprocess_threads=1, layout="NHWC")
    got, _ = _drain(tmx, draw_seed=11, **kw)
    want, _ = _drain(jmx, draw_seed=11, **kw)
    _equal(got, want)


def test_every_record_once_an_epoch_and_reset(rec):
    it = tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, H, W),
                                batch_size=4, shuffle=True, seed=1,
                                preprocess_threads=3, round_batch=False)
    for _ in range(2):
        seen = []
        for b in it:
            assert b.data[0].context == tmx.cpu()
            assert b.data[0].shape == (4, 3, H, W)
            seen.extend(int(v) for v in b.label[0].asnumpy())
        assert len(seen) == 20 and len(set(seen)) == 20
        it.reset()
    it.close()


def test_reader_decoder_and_metrics(rec):
    batches = registry.counter("io.record.batches")
    decoded = registry.counter("io.record.decoded")
    b0 = batches.get()
    dec = "libjpeg" if tnative.has_jpeg() else "pil"
    d0 = decoded.get(decoder=dec)
    it = tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, H, W),
                                batch_size=4, preprocess_threads=2,
                                round_batch=False)
    assert it.reader == ("native" if tnative.ensure_built() is not None
                         else "python")
    n = len(list(it))
    it.close()
    assert n == 5 and batches.get() == b0 + 5
    assert dict(it.decoders) == {dec: N}
    assert decoded.get(decoder=dec) >= d0 + N
    assert registry.counter("io.record.reader").get(reader=it.reader) >= 1
    depth = registry.gauge("io.record.queue_depth").get()
    assert 0 <= depth <= 4


def test_python_chunker_fallback(rec, monkeypatch):
    from mxnet_tpu_torch import _native

    def no_loader(*a, **k):
        raise _native.NativeError("no native library")
    monkeypatch.setattr(_native, "PrefetchLoader", no_loader)
    kw = dict(path_imgrec=rec, data_shape=(3, 16, 14), batch_size=4,
              shuffle=True, seed=2, preprocess_threads=2)
    got, it = _drain(tmx, **kw)
    assert it.reader == "python"
    want, _ = _drain(jmx, **kw)
    _equal(got, want)


def test_exhausted_iterator_raises_stop_iteration_repeatedly(rec):
    it = tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, H, W),
                                batch_size=8, round_batch=False,
                                preprocess_threads=2)
    assert len(list(it)) == 2
    for _ in range(3):
        with pytest.raises(StopIteration):
            it.next()
    it.close()


def _bad_rec(mod, path):
    w = mod.MXRecordIO(path, "w")
    for i in range(8):
        img = np.full((6, 5, 3), i * 9, np.uint8)
        w.write(mod.pack_img(mod.IRHeader(0, float(i), i, 0), img))
        if i == 3:                    # a record whose decode must fail
            w.write(mod.pack(mod.IRHeader(0, 99.0, 99, 0), b"NOT-AN-IMAGE"))
    w.close()
    return path


def test_bad_record_budget_as_jax(tmp_path):
    path = _bad_rec(trio, str(tmp_path / "bad.rec"))
    kw = dict(path_imgrec=path, data_shape=(3, 6, 5), batch_size=4,
              preprocess_threads=2)
    got, it = _drain(tmx, bad_record_budget=2, **kw)
    want, jit = _drain(jmx, bad_record_budget=2, **kw)
    _equal(got, want)
    assert it.bad_record_count == jit.bad_record_count == 1
    for mod, err in ((tmx, tmx.MXNetError), (jmx, jmx.MXNetError)):
        strict = mod.io.ImageRecordIter(**kw)
        with pytest.raises(err, match="bad-record budget"):
            for _ in strict:
                pass
        strict.close()


# -- the slice as a whole ----------------------------------------------------
def _narrow_resnets():
    from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
    from mxnet_tpu_torch.convert import gluon_params_from_jax
    from mxnet_tpu_torch.gluon.model_zoo import vision
    np.random.seed(4)
    jmx.random.seed(4)
    jnet = jresnet.ResNetV1(jresnet.BottleneckV1, [1, 1], [16, 32, 64],
                            classes=10, layout="NHWC")
    jnet.initialize(jmx.init.Xavier(magnitude=2))
    jnet.infer_shape(jmx.nd.zeros((1, 32, 32, 3)))
    for p in jnet.collect_params().values():
        p._finish_deferred_init()
    tnet = vision.ResNetV1(vision.BottleneckV1, [1, 1], [16, 32, 64],
                           classes=10, layout="NHWC", device="cpu")
    tnet.load_parameters(gluon_params_from_jax(jnet, "cpu", "NHWC"))
    return jnet, tnet


def _flat(state):
    import torch
    out = {}
    for kind, d in state.items():
        for k, v in d.items():
            if isinstance(v, torch.Tensor):
                arr = v.detach().double().numpy()
            else:
                arr = np.asarray(v, np.float64)
                if arr.ndim == 4:           # NHWC conv weight (O,kh,kw,I)
                    arr = arr.transpose(0, 3, 1, 2)
            out[kind + "/" + k.split("_", 1)[1]] = arr
    return out


def test_record_iter_feeds_sharded_trainer_as_jax(tmp_path):
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, \
        make_mesh as jax_make_mesh
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import ShardedTrainer
    path = write_rec(trio, tmp_path / "s.rec", 19, h=40, w=36, seed=3,
                     classes=10)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=8,
              layout="NHWC", shuffle=True, seed=5, rand_crop=True,
              rand_mirror=True, preprocess_threads=1, round_batch=False,
              mean_r=120.0, mean_g=120.0, mean_b=120.0, std_r=60.0,
              std_g=60.0, std_b=60.0)
    jnet, tnet = _narrow_resnets()
    sgd = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    st = ShardedTrainer(tnet, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        dict(sgd), device="cpu")
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    jst = JaxTrainer(jnet, lambda o, l: jloss(o, l), "sgd", dict(sgd),
                     mesh=jax_make_mesh({"dp": 1},
                                        devices=jax.devices()[:1]))
    losses = {}
    for name, mod, trainer in (("port", tmx, st), ("jax", jmx, jst)):
        random.seed(8)
        np.random.seed(8)
        it = mod.io.ImageRecordIter(**kw)
        if name == "port":
            loss = [float(trainer.step(*b)) for b in trainer.prefetched(it)]
        else:
            loss = [float(np.asarray(trainer.step(b.data[0],
                                                  b.label[0])._data))
                    for b in it]
        it.close()
        losses[name] = loss
    assert len(losses["port"]) == 2    # 19 records -> 2 batches of 8
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=TOL_REL, atol=TOL_REL)
    got = _flat({"param": st.params, "state": st.opt_state, "aux": st.aux})
    want = _flat({"param": {k: np.asarray(v) for k, v in
                            jst._params.items()},
                  "state": {k: np.asarray(v) for k, v in
                            jst._opt_state.items()},
                  "aux": {k: np.asarray(v) for k, v in jst._aux.items()}})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(got[k] - w).max()) / scale <= TOL_REL, k


def test_module_fit_over_record_iter_as_jax(tmp_path):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_module import lenet, _params_agree
    path = write_rec(trio, tmp_path / "m.rec", 24, h=14, w=14, seed=6,
                     classes=10)
    kw = dict(path_imgrec=path, data_shape=(3, 12, 12), batch_size=8,
              shuffle=True, seed=2, preprocess_threads=2,
              mean_r=120.0, mean_g=120.0, mean_b=120.0, std_r=60.0,
              std_g=60.0, std_b=60.0)
    ji, ti = jmx.io.ImageRecordIter(**kw), tmx.io.ImageRecordIter(**kw)
    js, ts = lenet(jmx), lenet(tmx)
    jm = jmx.mod.Module(js, context=jmx.cpu(), logger=logging)
    tm = tmx.mod.Module(ts, context=tmx.cpu(), logger=logging)
    jm.bind(ji.provide_data, ji.provide_label)
    tm.bind(ti.provide_data, ti.provide_label)
    jmx.random.seed(0)
    jm.init_params(jmx.init.Xavier(magnitude=2.0))
    args, auxs = jm.get_params()
    tm.init_params(arg_params={k: tmx.nd.array(v.asnumpy())
                               for k, v in args.items()},
                   aux_params={k: tmx.nd.array(v.asnumpy())
                               for k, v in auxs.items()})
    sgd = dict(optimizer="sgd",
               optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9),
                                 ("wd", 1e-4)))
    metrics = []
    for mod, it, mx in ((jm, ji, jmx), (tm, ti, tmx)):
        metric = mx.metric.create("ce")
        mod.fit(it, num_epoch=2, eval_metric=metric, **sgd)
        metrics.append(metric.get()[1])
        it.close()
    assert np.isfinite(metrics[1])
    np.testing.assert_allclose(metrics[1], metrics[0], rtol=LOSS_REL)
    _params_agree(jm, tm)


def test_train_imagenet_tool_on_the_cpu(tmp_path, capsys):
    """tools/torch_train_imagenet.py, the port's train_imagenet.py, over a
    .rec on the CPU: two epochs of a narrow net, finite losses."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import torch_train_imagenet
    path = write_rec(trio, tmp_path / "t.rec", 12, h=40, w=36, classes=10)
    loss = torch_train_imagenet.main([
        "--cpu", "--data-train", path, "--network", "resnet18_v1",
        "--image-shape", "3,32,32", "--batch-size", "4", "--num-classes",
        "10", "--dtype", "float32", "--num-epochs", "2", "--lr", "0.001",
        "--preprocess-threads", "2"])
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert out.count("img/s") == 2 and "record reader: " in out
