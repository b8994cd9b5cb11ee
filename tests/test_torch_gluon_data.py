"""Parity of the port's `gluon.data` (mxnet_tpu_torch/gluon/data/) with the
JAX package's, on the CPU: the samplers' order under one numpy seed,
the DataLoader at 0 and 2 worker processes in every `last_batch` mode
(and with a `batchify_fn`, a lazy `transform_first` and `pin_memory`),
each of the 15 vision transforms on the same image with the same Python
and numpy seeds, and the MNIST, CIFAR-10, CIFAR-100 and image-folder
readers over synthetic files written to `tmp_path`. Batches and images
are compared exactly (float transforms within 1e-5)."""
import gzip
import os
import random
import struct

import numpy as np
import jax
from jax._src import compilation_cache
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon import data as jdata
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import data as tdata

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_compile_cache():
    """The session's persistent compile cache (tests/conftest.py) installs
    a read guard that takes one argument fewer than jax 0.9 passes it, so
    every JAX compile under it raises. This module's JAX compiles run with
    the cache off; the setting is restored, and the cache reset, after."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _np(batch):
    if isinstance(batch, (list, tuple)):
        return [_np(b) for b in batch]
    return batch.asnumpy()


def test_random_sampler_order_equals_jax_under_one_seed():
    np.random.seed(11)
    want = list(jdata.RandomSampler(50))
    np.random.seed(11)
    got = list(tdata.RandomSampler(50))
    assert got == want and sorted(got) == list(range(50))
    assert list(tdata.SequentialSampler(5)) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("mode", ["keep", "discard", "rollover"])
def test_batch_sampler_equals_jax(mode):
    j = jdata.BatchSampler(jdata.SequentialSampler(10), 4, mode)
    t = tdata.BatchSampler(tdata.SequentialSampler(10), 4, mode)
    for _ in range(3):      # rollover carries over between epochs
        assert list(t) == list(j) and len(t) == len(j)
    with pytest.raises(ValueError, match="last_batch"):
        list(tdata.BatchSampler(tdata.SequentialSampler(3), 2, "drop"))


def _arrays():
    r = np.random.RandomState(2)
    return (r.randn(10, 3, 2).astype(np.float32),
            r.randint(0, 5, 10).astype(np.float32))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("mode", ["keep", "discard", "rollover"])
def test_dataloader_batches_equal_jax(mode, workers):
    x, y = _arrays()
    jl = jdata.DataLoader(jdata.ArrayDataset(x, y), batch_size=4,
                          shuffle=True, last_batch=mode)
    tl = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                          shuffle=True, last_batch=mode,
                          num_workers=workers)
    for epoch in range(2):
        expect = len(tl)        # rollover's length counts the carried part
        np.random.seed(epoch)
        want = [_np(b) for b in jl]
        np.random.seed(epoch)
        got = list(tl)
        assert len(got) == len(want) == expect
        for g, w in zip(got, want):
            assert isinstance(g[0], nd.NDArray) and g[0].context == tmx.cpu()
            for a, b in zip(_np(g), w):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    del tl


def test_dataloader_batchify_transform_and_pin_memory():
    x, y = _arrays()
    img = (np.arange(10 * 4 * 4 * 3) % 256).astype(np.uint8) \
        .reshape(10, 4, 4, 3)

    def batchify(samples):
        return np.stack([s[0] for s in samples]) * 2

    jl = jdata.DataLoader(jdata.ArrayDataset(x, y), batch_size=3,
                          batchify_fn=batchify)
    for workers in (0, 2):
        tl = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=3,
                              batchify_fn=batchify, num_workers=workers,
                              pin_memory=True, prefetch=1)
        for g, w in zip(tl, jl):
            assert np.array_equal(g.asnumpy(), w.asnumpy())
        del tl
    # a lazy transform of the first element, run in the workers
    jds = jdata.ArrayDataset(mx.nd.array(img, dtype="uint8"), y) \
        .transform_first(jdata.vision.transforms.ToTensor())
    tds = tdata.ArrayDataset(nd.array(img, dtype="uint8"), y) \
        .transform_first(tdata.vision.transforms.ToTensor())
    assert len(tds) == 10
    want = [_np(b) for b in jdata.DataLoader(jds, batch_size=5)]
    tl = tdata.DataLoader(tds, batch_size=5, num_workers=2)
    got = [_np(b) for b in tl]
    del tl
    for g, w in zip(got, want):
        assert g[0].shape == (5, 3, 4, 4)
        assert np.abs(g[0] - w[0]).max() < TOL and np.array_equal(g[1], w[1])
    eager = tds.transform(lambda a, b: (a, b + 1), lazy=False)
    assert isinstance(eager, tdata.SimpleDataset) and eager[0][1] == y[0] + 1


def _image():
    r = np.random.RandomState(3)
    return (r.rand(12, 10, 3) * 255).astype(np.uint8)


TRANSFORMS = {
    "Resize": lambda T: T.Resize(6),
    "Resize_keep_ratio": lambda T: T.Resize(6, keep_ratio=True),
    "CenterCrop": lambda T: T.CenterCrop((6, 8)),
    "RandomResizedCrop": lambda T: T.RandomResizedCrop(5),
    "RandomFlipLeftRight": lambda T: T.RandomFlipLeftRight(),
    "RandomFlipTopBottom": lambda T: T.RandomFlipTopBottom(),
    "RandomBrightness": lambda T: T.RandomBrightness(0.4),
    "RandomContrast": lambda T: T.RandomContrast(0.4),
    "RandomSaturation": lambda T: T.RandomSaturation(0.4),
    "RandomHue": lambda T: T.RandomHue(0.3),
    "RandomColorJitter": lambda T: T.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
    "RandomLighting": lambda T: T.RandomLighting(0.5),
    "Cast": lambda T: T.Cast("float32"),
    "ToTensor": lambda T: T.ToTensor(),
    "Compose": lambda T: T.Compose([T.Resize(8), T.CenterCrop(6),
                                    T.ToTensor(),
                                    T.Normalize((0.5, 0.4, 0.3),
                                                (0.2, 0.25, 0.3))]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_equals_jax(name):
    make = TRANSFORMS[name]
    img = _image()
    outs = []
    for T, arr in ((jdata.vision.transforms, mx.nd.array),
                   (tdata.vision.transforms, nd.array)):
        t = make(T)
        got = []
        for seed in range(4):
            random.seed(seed)
            np.random.seed(seed)
            got.append(t(arr(img, dtype="uint8")).asnumpy())
        outs.append(got)
    for w, g in zip(*outs):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.abs(g.astype(np.float64) - w.astype(np.float64)).max() \
            <= (TOL if g.dtype == np.float32 else 0), name


def _idx_files(root, n=7):
    r = np.random.RandomState(4)
    images = (r.rand(n, 28, 28) * 255).astype(np.uint8)
    labels = r.randint(0, 10, n).astype(np.uint8)
    os.makedirs(root, exist_ok=True)
    with gzip.open(os.path.join(root, "train-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with open(os.path.join(root, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return images, labels


def test_mnist_reads_idx_files_as_jax_does(tmp_path):
    root = str(tmp_path / "mnist")
    images, labels = _idx_files(root)
    j = jdata.vision.MNIST(root=root)
    t = tdata.vision.MNIST(root=root)
    f = tdata.vision.FashionMNIST(root=root)
    assert len(t) == len(j) == len(f) == 7
    for i in range(7):
        (ti, tlab), (ji, jlab) = t[i], j[i]
        assert np.array_equal(ti.asnumpy(), ji.asnumpy())
        assert np.array_equal(ti.asnumpy()[:, :, 0], images[i])
        assert tlab == jlab == labels[i]
        assert ti.context == tmx.cpu()
    with pytest.raises(RuntimeError, match="not found"):
        tdata.vision.MNIST(root=str(tmp_path / "empty"), train=False)


def _cifar_record(r, n, labels):
    data = (r.rand(n, 3072) * 255).astype(np.uint8)
    lab = r.randint(0, 10, (n, labels)).astype(np.uint8)
    return np.concatenate([lab, data], 1), data, lab


def test_cifar10_and_cifar100_read_binary_batches(tmp_path):
    r = np.random.RandomState(5)
    root10 = tmp_path / "cifar10" / "cifar-10-batches-bin"
    root10.mkdir(parents=True)
    rows = []
    for i in range(1, 6):
        rec, data, lab = _cifar_record(r, 2, 1)
        (root10 / ("data_batch_%d.bin" % i)).write_bytes(rec.tobytes())
        rows.append((data, lab))
    rec, _, _ = _cifar_record(r, 3, 1)
    (root10 / "test_batch.bin").write_bytes(rec.tobytes())
    j = jdata.vision.CIFAR10(root=str(tmp_path / "cifar10"))
    t = tdata.vision.CIFAR10(root=str(tmp_path / "cifar10"))
    assert len(t) == len(j) == 10
    assert len(tdata.vision.CIFAR10(root=str(tmp_path / "cifar10"),
                                    train=False)) == 3
    for i in range(10):
        assert np.array_equal(t[i][0].asnumpy(), j[i][0].asnumpy())
        assert t[i][1] == j[i][1]
    data, lab = rows[0]
    assert np.array_equal(t[0][0].asnumpy(),
                          data[0].reshape(3, 32, 32).transpose(1, 2, 0))
    assert t[1][1] == lab[1, 0]
    # CIFAR-100: train.bin, coarse then fine label
    root100 = tmp_path / "cifar100"
    root100.mkdir()
    rec, data, lab = _cifar_record(r, 4, 2)
    (root100 / "train.bin").write_bytes(rec.tobytes())
    coarse = tdata.vision.CIFAR100(root=str(root100))
    fine = tdata.vision.CIFAR100(root=str(root100), fine_label=True)
    assert len(coarse) == 4
    assert [coarse[i][1] for i in range(4)] == lab[:, 0].tolist()
    assert [fine[i][1] for i in range(4)] == lab[:, 1].tolist()
    assert np.array_equal(fine[2][0].asnumpy(),
                          data[2].reshape(3, 32, 32).transpose(1, 2, 0))


def test_image_folder_dataset_equals_jax(tmp_path):
    from PIL import Image
    r = np.random.RandomState(6)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for k in range(2):
            Image.fromarray((r.rand(5, 4, 3) * 255).astype(np.uint8)).save(
                str(tmp_path / cls / ("%d.png" % k)))
    (tmp_path / "notes.txt").write_text("not a class")
    with pytest.warns(UserWarning):
        j = jdata.vision.ImageFolderDataset(str(tmp_path))
    with pytest.warns(UserWarning):
        t = tdata.vision.ImageFolderDataset(str(tmp_path))
    assert t.synsets == j.synsets == ["cat", "dog"]
    assert len(t) == len(j) == 4
    for i in range(4):
        assert np.array_equal(t[i][0].asnumpy(), j[i][0].asnumpy())
        assert t[i][1] == j[i][1]


def test_dataloader_argument_checks():
    ds = tdata.SimpleDataset(list(range(5)))
    with pytest.raises(ValueError, match="batch_size"):
        tdata.DataLoader(ds)
    with pytest.raises(ValueError, match="shuffle"):
        tdata.DataLoader(ds, 2, shuffle=True,
                         sampler=tdata.SequentialSampler(5))
    with pytest.raises(ValueError, match="batch_sampler"):
        tdata.DataLoader(ds, 2, batch_sampler=tdata.BatchSampler(
            tdata.SequentialSampler(5), 2))
    batches = [b.asnumpy().tolist() for b in tdata.DataLoader(ds, 2)]
    assert batches == [[0, 1], [2, 3], [4]]
