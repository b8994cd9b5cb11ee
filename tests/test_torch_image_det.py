"""Parity of the port's detection pipeline (mxnet_tpu_torch/image_det.py)
with the JAX package's, on the CPU: each Det* augmenter,
`CreateMultiRandCropAugmenter` and `CreateDetAugmenter` on the same image
and boxes under the same `random.seed`/`np.random.seed`, and
`ImageDetIter` over a packed .rec (its images and padded boxes, after
`reshape` and `sync_label_shape`, and `draw_next`'s images). Geometric
results are compared exactly; chains with colour jitter within 1e-6."""
import os
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import image as jimg
from mxnet_tpu_torch import image as timg, recordio as trio

from torch_record_parity import (no_persistent_compile_cache,  # noqa: F401
                                 port_native_library)

TOL = 1e-6


@pytest.fixture(autouse=True)
def _env(no_persistent_compile_cache, port_native_library):  # noqa: F811
    with tmx.cpu():
        yield


def _scene(rng, size=32, n_obj=1):
    img = np.zeros((size, size, 3), np.uint8)
    objs = []
    for _ in range(n_obj):
        w = rng.randint(8, 16)
        x0 = rng.randint(0, size - w)
        y0 = rng.randint(0, size - w)
        img[y0:y0 + w, x0:x0 + w] = rng.randint(100, 255)
        objs.append([rng.randint(0, 3), x0 / size, y0 / size,
                     (x0 + w) / size, (y0 + w) / size])
    return img, np.asarray(objs, np.float32)


def _write_rec(path, n=8, max_obj=3, seed=5):
    rng = np.random.RandomState(seed)
    rec = trio.MXIndexedRecordIO(str(path) + ".idx", str(path) + ".rec", "w")
    for i in range(n):
        img, objs = _scene(rng, n_obj=rng.randint(1, max_obj + 1))
        label = np.concatenate([[2, 5], objs.ravel()]).astype(np.float32)
        rec.write_idx(i, trio.pack_img(trio.IRHeader(0, label, i, 0), img,
                                       img_fmt=".png"))
    rec.close()
    return str(path) + ".rec"


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _same(got, want, tol=0.0):
    (gi, gl), (wi, wl) = got, want
    gi, wi = gi.asnumpy(), np.asarray(wi.asnumpy())
    assert gi.shape == wi.shape and gi.dtype == wi.dtype
    if tol:
        np.testing.assert_allclose(gi, wi, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)


AUGS = {
    "flip": lambda m: m.DetHorizontalFlipAug(0.5),
    "crop": lambda m: m.DetRandomCropAug(min_object_covered=0.3,
                                         area_range=(0.2, 1.0)),
    "pad": lambda m: m.DetRandomPadAug(area_range=(1.0, 3.0)),
    "borrow": lambda m: m.DetBorrowAug(m.ForceResizeAug((20, 18))),
    "select": lambda m: m.DetRandomSelectAug(
        [m.DetHorizontalFlipAug(1.0), m.DetRandomPadAug()], skip_prob=0.3),
    "multi_crop": lambda m: m.CreateMultiRandCropAugmenter(
        min_object_covered=0.3, area_range=[(0.1, 1.0), (0.3, 1.0)],
        aspect_ratio_range=[(0.75, 1.33), (0.5, 2.0)], skip_prob=0.2),
}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(AUGS))
def test_det_augmenter_equals_jax(name, seed):
    img, objs = _scene(np.random.RandomState(seed), size=40, n_obj=3)
    aug_t, aug_j = AUGS[name](timg), AUGS[name](jimg)
    _seed(seed)
    got = aug_t(tmx.nd.array(img, ctx=tmx.cpu()), objs.copy())
    _seed(seed)
    want = aug_j(jmx.nd.array(img), objs.copy())
    assert got[0].context == tmx.cpu()
    _same(got, want)
    assert aug_t.dumps() == aug_j.dumps()


def test_multi_rand_crop_keeps_jaxs_scalar_list_rule():
    """A list of scalars (min_object_covered=[0.1, 0.5]) is one value to
    the JAX package (only lists of tuples are split, image_det.py:285),
    so its crop compares an array with a float and raises; the port keeps
    that rule (ROADMAP C12)."""
    img, objs = _scene(np.random.RandomState(0), size=40, n_obj=3)
    for m, arr in ((timg, tmx.nd.array(img, ctx=tmx.cpu())),
                   (jimg, jmx.nd.array(img))):
        aug = m.CreateMultiRandCropAugmenter(min_object_covered=[0.1, 0.5])
        assert len(aug.aug_list) == 1
        _seed(0)
        with pytest.raises(ValueError, match="truth value"):
            aug.aug_list[0](arr, objs.copy())


@pytest.mark.parametrize("kw", [
    dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True),
    dict(resize=40, rand_crop=1, rand_gray=0.5, mean=True, std=True),
    dict(rand_mirror=True, brightness=0.1, contrast=0.1, saturation=0.1,
         hue=0.1, pca_noise=0.05)])
def test_create_det_augmenter_equals_jax(kw):
    chain_t = timg.CreateDetAugmenter((3, 24, 24), **kw)
    chain_j = jimg.CreateDetAugmenter((3, 24, 24), **kw)
    assert len(chain_t) == len(chain_j)
    for seed in range(4):
        img, objs = _scene(np.random.RandomState(seed), n_obj=2)
        t = (tmx.nd.array(img, ctx=tmx.cpu()), objs.copy())
        j = (jmx.nd.array(img), objs.copy())
        _seed(seed)
        for a in chain_t:
            t = a(*t)
        _seed(seed)
        for a in chain_j:
            j = a(*j)
        assert tuple(t[0].shape) == (24, 24, 3)
        _same(t, j, TOL)


def _det_batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


@pytest.mark.parametrize("shuffle", [False, True])
def test_image_det_iter_equals_jax(tmp_path, shuffle):
    rec = _write_rec(tmp_path / "scenes", n=7)
    kw = dict(batch_size=3, data_shape=(3, 24, 24), path_imgrec=rec,
              shuffle=shuffle, rand_crop=0.5, rand_pad=0.5, rand_mirror=True)
    _seed(3)
    ti = timg.ImageDetIter(**kw)
    got = _det_batches(ti)
    _seed(3)
    ji = jimg.ImageDetIter(**kw)
    want = _det_batches(ji)
    assert ti.provide_label == ji.provide_label
    assert ti.max_objects == ji.max_objects
    assert len(got) == len(want) == 3
    for (gx, gy, gp), (wx, wy, wp) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gp == wp
    assert got[-1][2] == 2
    # a larger padded label, then a second epoch
    for it in (ti, ji):
        it.reshape(label_shape=(it.max_objects + 2, 6))
    _seed(4)
    ti.reset()
    got = _det_batches(ti)
    _seed(4)
    ji.reset()
    want = _det_batches(ji)
    assert got[0][1].shape == (3, ti.max_objects, 6)
    for (gx, gy, _), (wx, wy, _) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    with pytest.raises(tmx.MXNetError, match="too small"):
        ti.reshape(label_shape=(1, 5))


def test_sync_label_shape_and_draw_next_equal_jax(tmp_path):
    r1 = _write_rec(tmp_path / "a", n=4, max_obj=1, seed=1)
    r2 = _write_rec(tmp_path / "b", n=4, max_obj=3, seed=2)
    shapes = []
    for m in (timg, jimg):
        it1 = m.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                             path_imgrec=r1)
        it2 = m.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                             path_imgrec=r2)
        it2 = it1.sync_label_shape(it2)
        assert it1.provide_label[0].shape == it2.provide_label[0].shape
        shapes.append(it1.provide_label[0].shape)
    assert shapes[0] == shapes[1]
    draws = [list(m.ImageDetIter(batch_size=1, data_shape=(3, 32, 32),
                                 path_imgrec=r2).draw_next(
        color=(255, 0, 0), thickness=1)) for m in (timg, jimg)]
    assert len(draws[0]) == len(draws[1]) == 4
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a, b)


def test_invalid_labels_raise_as_jax(tmp_path):
    rec = trio.MXIndexedRecordIO(str(tmp_path / "bad.idx"),
                                 str(tmp_path / "bad.rec"), "w")
    img, _ = _scene(np.random.RandomState(0))
    label = np.asarray([2, 4, 0, 0.1, 0.2, 0.3, 0.4], np.float32)
    rec.write_idx(0, trio.pack_img(trio.IRHeader(0, label, 0, 0), img))
    rec.close()
    for m, err in ((timg, tmx.MXNetError), (jimg, jmx.MXNetError)):
        with pytest.raises(err, match="invalid detection label"):
            m.ImageDetIter(path_imgrec=os.path.join(str(tmp_path), "bad.rec"),
                           batch_size=1, data_shape=(3, 32, 32))
