"""Parity of the port's other file iterators and record datasets with the
JAX package's, on the CPU: `CSVIter`, `MNISTIter` (on synthetic idx
files, plain and gzipped), `LibSVMIter` (CSR batches, dense and sparse
labels) and `PrefetchingIter` give identical batches;
`gluon.data.RecordFileDataset`, `vision.ImageRecordDataset` through a
`DataLoader` (at 0 and 2 worker processes) and
`gluon.contrib.data.IntervalSampler` give identical items. Batches are
compared exactly."""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio as trio

from torch_record_parity import (no_persistent_compile_cache,  # noqa: F401
                                 port_native_library, write_rec)


@pytest.fixture(autouse=True)
def _env(no_persistent_compile_cache, port_native_library):  # noqa: F811
    with tmx.cpu():
        yield


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _batches(it):
    out = []
    for b in it:
        out.append(([_np(d) for d in b.data], [_np(lab) for lab in b.label],
                    b.pad))
    return out


def _equal(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        for g, w in zip(gd + gl, wd + wl):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert gp == wp


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("with_label", [True, False])
def test_csv_iter_equals_jax(tmp_path, round_batch, with_label):
    rng = np.random.RandomState(0)
    data = rng.rand(10, 6).astype(np.float32)
    np.savetxt(str(tmp_path / "d.csv"), data, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              batch_size=4, round_batch=round_batch)
    if with_label:
        np.savetxt(str(tmp_path / "l.csv"), np.arange(10.0), delimiter=",")
        kw["label_csv"] = str(tmp_path / "l.csv")
    ti, ji = tmx.io.CSVIter(**kw), jmx.io.CSVIter(**kw)
    assert ti.provide_data == ji.provide_data
    assert ti.provide_label == ji.provide_label
    _equal(_batches(ti), _batches(ji))
    ti.reset()
    ji.reset()
    _equal(_batches(ti), _batches(ji))


def _idx_file(path, arr, gz):
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter_equals_jax(tmp_path, gz, flat):
    rng = np.random.RandomState(1)
    suffix = ".gz" if gz else ""
    img, lbl = str(tmp_path / ("i" + suffix)), str(tmp_path / ("l" + suffix))
    _idx_file(img, rng.randint(0, 256, (13, 7, 5)), gz)
    _idx_file(lbl, rng.randint(0, 10, 13), gz)
    kw = dict(image=img, label=lbl, batch_size=4, shuffle=True, flat=flat)
    np.random.seed(3)
    ti = tmx.io.MNISTIter(**kw)
    got = _batches(ti)
    np.random.seed(3)
    ji = jmx.io.MNISTIter(**kw)
    _equal(got, _batches(ji))
    assert ti.provide_data == ji.provide_data
    assert ti.provide_label == ji.provide_label


def _libsvm(path, rows, dim, rng):
    with open(path, "w") as f:
        for i in range(rows):
            idx = sorted(rng.choice(dim, rng.randint(1, 4), replace=False))
            f.write("%d %s\n" % (i % 3, " ".join(
                "%d:%.3f" % (j, rng.rand()) for j in idx)))


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("sparse_label", [False, True])
def test_libsvm_iter_equals_jax(tmp_path, round_batch, sparse_label):
    rng = np.random.RandomState(2)
    data = str(tmp_path / "d.libsvm")
    _libsvm(data, 7, 9, rng)
    kw = dict(data_libsvm=data, data_shape=(9,), batch_size=3,
              round_batch=round_batch)
    if sparse_label:
        lab = str(tmp_path / "l.libsvm")
        _libsvm(lab, 7, 4, rng)
        kw.update(label_libsvm=lab, label_shape=(4,))
    ti, ji = tmx.io.LibSVMIter(**kw), jmx.io.LibSVMIter(**kw)
    got, want = [], []
    for it, out in ((ti, got), (ji, want)):
        for b in it:
            csr = b.data[0]
            assert csr.stype == "csr" and csr.shape == (3, 9)
            out.append(([_np(csr), _np(csr.indices), _np(csr.indptr),
                         _np(csr.data)], [_np(b.label[0])], b.pad))
    _equal(got, want)
    ti.reset()
    assert len(list(ti)) == len(got)


def test_prefetching_iter_equals_jax():
    rng = np.random.RandomState(4)
    x, y = rng.rand(10, 3).astype(np.float32), np.arange(10.0)
    x2 = rng.rand(10, 2).astype(np.float32)
    ti = tmx.io.PrefetchingIter(
        [tmx.io.NDArrayIter(x, y, batch_size=4),
         tmx.io.NDArrayIter(x2, y, batch_size=4, data_name="d2",
                            label_name="l2")],
        rename_data=[{"data": "a"}, {"d2": "b"}])
    ji = jmx.io.PrefetchingIter(
        [jmx.io.NDArrayIter(x, y, batch_size=4),
         jmx.io.NDArrayIter(x2, y, batch_size=4, data_name="d2",
                            label_name="l2")],
        rename_data=[{"data": "a"}, {"d2": "b"}])
    assert [d.name for d in ti.provide_data] == ["a", "b"]
    assert ti.provide_data == ji.provide_data
    assert ti.provide_label == ji.provide_label
    for _ in range(2):
        _equal(_batches(ti), _batches(ji))
        ti.reset()
        ji.reset()
    one = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(x, y, batch_size=5))
    assert one.batch_size == 5 and len(list(one)) == 2


def test_record_file_dataset_equals_jax(tmp_path):
    from mxnet_tpu.gluon.data import RecordFileDataset as JRec
    path = write_rec(trio, tmp_path / "r.rec", 7)
    td, jd = tmx.gluon.data.RecordFileDataset(path), JRec(path)
    assert len(td) == len(jd) == 7
    assert [td[i] for i in (6, 0, 3)] == [jd[i] for i in (6, 0, 3)]


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("flag", [0, 1])
def test_image_record_dataset_through_dataloader_equals_jax(tmp_path, workers,
                                                            flag):
    from mxnet_tpu.gluon.data import DataLoader as JLoader
    from mxnet_tpu.gluon.data.vision import ImageRecordDataset as JDs
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset
    path = write_rec(trio, tmp_path / "v.rec", 10, h=12, w=10)
    td, jd = ImageRecordDataset(path, flag=flag), JDs(path, flag=flag)
    img, lab = td[3]
    assert img.context == tmx.cpu() and img.dtype == np.uint8
    np.testing.assert_array_equal(img.asnumpy(), jd[3][0].asnumpy())
    assert lab == jd[3][1]
    got = [(_np(x), _np(y)) for x, y in
           DataLoader(td, batch_size=4, num_workers=workers,
                      last_batch="keep")]
    want = [(_np(x), _np(y)) for x, y in
            JLoader(jd, batch_size=4, last_batch="keep")]
    assert len(got) == len(want) == 3
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    # a transform rides on each item
    tt = ImageRecordDataset(path, transform=lambda x, y: (x, y + 1))
    assert tt[2][1] == jd[2][1] + 1
    lazy = td.transform_first(lambda x: x)
    got = [_np(y) for _, y in DataLoader(lazy, batch_size=5, num_workers=2)]
    np.testing.assert_array_equal(np.concatenate(got), np.arange(10.0))


@pytest.mark.parametrize("rollover", [True, False])
@pytest.mark.parametrize("length,interval", [(10, 3), (7, 7), (9, 1)])
def test_interval_sampler_equals_jax(length, interval, rollover):
    from mxnet_tpu.gluon.contrib.data import IntervalSampler as J
    t = tmx.gluon.contrib.data.IntervalSampler(length, interval, rollover)
    j = J(length, interval, rollover)
    assert list(t) == list(j) and len(t) == len(j)
