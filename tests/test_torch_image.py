"""Parity of the port's image module (mxnet_tpu_torch/image.py) with the
JAX package's, on the CPU: decode and read, resize, the crop helpers,
`color_normalize`, every Augmenter and the `CreateAugmenter` chains
under the same `random.seed`/`np.random.seed` (bit-identical, or within
1e-6 where float32 arithmetic may be reordered), and `ImageIter` over a
.rec file and over an image list. The port's results are host (CPU)
NDArrays."""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import image as jimg
from mxnet_tpu_torch import image as timg, recordio as trio

from torch_record_parity import (no_persistent_compile_cache,  # noqa: F401
                                 port_native_library, smooth_image,
                                 write_rec)

TOL = 1e-6      # float32 augmenters whose arithmetic may be reordered


@pytest.fixture(autouse=True)
def _env(no_persistent_compile_cache, port_native_library):  # noqa: F811
    yield


def _img(h=24, w=30, seed=0):
    return smooth_image(np.random.RandomState(seed), h, w, 3)


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _same(got, want, tol=0.0):
    assert isinstance(got, tmx.nd.NDArray)
    assert got.context == tmx.cpu()
    g, w = got.asnumpy(), np.asarray(want.asnumpy())
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape,
                                                       g.dtype, w.dtype)
    if tol:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(g, w)


def _jpeg(img, quality=90):
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("flag", [0, 1])
def test_imdecode_and_imread_equal_jax(tmp_path, flag):
    data = _jpeg(_img())
    _same(timg.imdecode(data, flag=flag), jimg.imdecode(data, flag=flag))
    f = str(tmp_path / "im.jpg")
    with open(f, "wb") as fh:
        fh.write(data)
    _same(timg.imread(f, flag=flag), jimg.imread(f, flag=flag))
    # an NDArray of the bytes decodes the same
    buf = tmx.nd.array(np.frombuffer(data, np.uint8), ctx=tmx.cpu(),
                       dtype="uint8")
    _same(timg.imdecode(buf, flag=flag), jimg.imdecode(data, flag=flag))


def test_imresize_resize_short_border_and_normalize_equal_jax():
    img = _img()
    _same(timg.imresize(img, 17, 11), jimg.imresize(img, 17, 11))
    for size in (12, 40):
        _same(timg.resize_short(img, size), jimg.resize_short(img, size))
    _same(timg.copyMakeBorder(img, 1, 2, 3, 4, fill_value=7),
          jimg.copyMakeBorder(img, 1, 2, 3, 4, fill_value=7))
    mean, std = np.array([10.0, 20.0, 30.0]), np.array([2.0, 3.0, 4.0])
    _same(timg.color_normalize(img, mean, std),
          jimg.color_normalize(img, mean, std), TOL)
    _same(timg.color_normalize(tmx.nd.array(img, ctx=tmx.cpu()), mean),
          jimg.color_normalize(jmx.nd.array(img), mean), TOL)
    assert timg.scale_down((30, 24), (40, 20)) == \
        jimg.scale_down((30, 24), (40, 20))


@pytest.mark.parametrize("seed", [0, 5])
def test_crop_helpers_equal_jax(seed):
    img = _img()
    _same(timg.fixed_crop(img, 2, 3, 10, 8), jimg.fixed_crop(img, 2, 3, 10, 8))
    _same(timg.fixed_crop(img, 2, 3, 10, 8, size=(6, 5)),
          jimg.fixed_crop(img, 2, 3, 10, 8, size=(6, 5)))
    for fn in ("random_crop", "center_crop"):
        _seed(seed)
        t, tbox = getattr(timg, fn)(img, (12, 10))
        _seed(seed)
        j, jbox = getattr(jimg, fn)(img, (12, 10))
        _same(t, j)
        assert tbox == jbox
    _seed(seed)
    t, tbox = timg.random_size_crop(img, (12, 10), (0.3, 1.0), (0.75, 1.33))
    _seed(seed)
    j, jbox = jimg.random_size_crop(img, (12, 10), (0.3, 1.0), (0.75, 1.33))
    _same(t, j)
    assert tbox == jbox


EIGVAL = [55.46, 4.794, 1.148]
EIGVEC = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
          [-0.5836, -0.6948, 0.4203]]
AUGS = {
    "ResizeAug": (lambda m: m.ResizeAug(14), 0.0),
    "ForceResizeAug": (lambda m: m.ForceResizeAug((13, 9)), 0.0),
    "RandomCropAug": (lambda m: m.RandomCropAug((12, 10)), 0.0),
    "CenterCropAug": (lambda m: m.CenterCropAug((12, 10)), 0.0),
    "RandomSizedCropAug": (lambda m: m.RandomSizedCropAug(
        (12, 10), (0.08, 1.0), (0.75, 1.33)), 0.0),
    "HorizontalFlipAug": (lambda m: m.HorizontalFlipAug(0.5), 0.0),
    "CastAug": (lambda m: m.CastAug(), 0.0),
    "BrightnessJitterAug": (lambda m: m.BrightnessJitterAug(0.4), TOL),
    "ContrastJitterAug": (lambda m: m.ContrastJitterAug(0.4), TOL),
    "SaturationJitterAug": (lambda m: m.SaturationJitterAug(0.4), TOL),
    "HueJitterAug": (lambda m: m.HueJitterAug(0.3), TOL),
    "RandomGrayAug": (lambda m: m.RandomGrayAug(0.5), TOL),
    "ColorJitterAug": (lambda m: m.ColorJitterAug(0.3, 0.3, 0.3), TOL),
    "LightingAug": (lambda m: m.LightingAug(0.1, EIGVAL, EIGVEC), TOL),
    "ColorNormalizeAug": (lambda m: m.ColorNormalizeAug(
        [123.68, 116.28, 103.53], [58.395, 57.12, 57.375]), TOL),
    "SequentialAug": (lambda m: m.SequentialAug(
        [m.RandomCropAug((12, 10)), m.HorizontalFlipAug(0.5),
         m.CastAug()]), 0.0),
    "RandomOrderAug": (lambda m: m.RandomOrderAug(
        [m.BrightnessJitterAug(0.2), m.ContrastJitterAug(0.2),
         m.SaturationJitterAug(0.2)]), TOL),
}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenter_equals_jax_under_one_seed(name, seed):
    make, tol = AUGS[name]
    img = _img(seed=seed)
    src_t, src_j = tmx.nd.array(img, ctx=tmx.cpu()), jmx.nd.array(img)
    if tol:      # the colour augmenters run on float images
        src_t = timg.CastAug()(src_t)
        src_j = jimg.CastAug()(src_j)
    aug_t, aug_j = make(timg), make(jimg)
    _seed(seed)
    got = aug_t(src_t)
    _seed(seed)
    want = aug_j(src_j)
    _same(got, want, tol)
    assert aug_t.dumps() == aug_j.dumps()


CHAINS = [
    dict(),
    dict(resize=20, rand_crop=True, rand_mirror=True),
    dict(rand_crop=True, rand_resize=True, mean=True, std=True),
    dict(rand_mirror=True, brightness=0.2, contrast=0.2, saturation=0.2,
         hue=0.1, pca_noise=0.1, rand_gray=0.3),
    dict(mean=np.array([1.0, 2.0, 3.0]), std=None, inter_method=1),
]


@pytest.mark.parametrize("i", range(len(CHAINS)))
def test_create_augmenter_chain_equals_jax(i):
    kw = CHAINS[i]
    chain_t = timg.CreateAugmenter((3, 12, 10), **kw)
    chain_j = jimg.CreateAugmenter((3, 12, 10), **kw)
    assert [a.dumps() for a in chain_t] == [a.dumps() for a in chain_j]
    for seed in (0, 9):
        img = _img(seed=seed)
        t, j = tmx.nd.array(img, ctx=tmx.cpu()), jmx.nd.array(img)
        _seed(seed)
        for a in chain_t:
            t = a(t)
        _seed(seed)
        for a in chain_j:
            j = a(j)
        _same(t, j, TOL)


def _batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _equal_batches(got, want):
    assert len(got) == len(want)
    for (gx, gy, gp), (wx, wy, wp) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gp == wp


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("parts", [(0, 1), (1, 3)])
def test_image_iter_over_rec_equals_jax(tmp_path, shuffle, parts):
    path = write_rec(trio, tmp_path / "d.rec", 11, h=16, w=14)
    kw = dict(batch_size=4, data_shape=(3, 12, 10), path_imgrec=path,
              shuffle=shuffle, rand_crop=True, rand_mirror=True,
              part_index=parts[0], num_parts=parts[1])
    _seed(4)
    it_t = timg.ImageIter(**kw)
    got = _batches(it_t)
    _seed(4)
    it_j = jimg.ImageIter(**kw)
    want = _batches(it_j)
    _equal_batches(got, want)
    _seed(5)            # a second epoch: a new order when shuffled
    it_t.reset()
    got = _batches(it_t)
    _seed(5)
    it_j.reset()
    _equal_batches(got, _batches(it_j))
    assert it_t.provide_data == it_j.provide_data
    assert it_t.provide_label == it_j.provide_label


def test_image_iter_over_image_list_equals_jax(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(2)
    lines = []
    for i in range(6):
        name = "im%d.jpg" % i
        Image.fromarray(smooth_image(rng, 14, 12, i)).save(
            str(tmp_path / name), quality=90)
        lines.append("%d\t%d\t%d\t%s" % (i, i % 3, i, name))
    lst = str(tmp_path / "list.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    kw = dict(batch_size=4, data_shape=(3, 10, 10), path_imglist=lst,
              path_root=str(tmp_path), label_width=2)
    _equal_batches(_batches(timg.ImageIter(**kw)),
                   _batches(jimg.ImageIter(**kw)))
    imglist = [([float(i)], "im%d.jpg" % i) for i in range(6)]
    kw = dict(batch_size=3, data_shape=(3, 10, 10), imglist=imglist,
              path_root=str(tmp_path))
    _equal_batches(_batches(timg.ImageIter(**kw)),
                   _batches(jimg.ImageIter(**kw)))
    with pytest.raises(tmx.MXNetError, match="part_index"):
        timg.ImageIter(batch_size=2, data_shape=(3, 4, 4), imglist=imglist,
                       part_index=2, num_parts=2)
    with pytest.raises(tmx.MXNetError):
        timg.ImageIter(batch_size=2, data_shape=(3, 4, 4))


def test_image_iter_batches_are_host_arrays(tmp_path):
    path = write_rec(trio, tmp_path / "h.rec", 3, h=8, w=8)
    b = next(iter(timg.ImageIter(batch_size=2, data_shape=(3, 8, 8),
                                 path_imgrec=path)))
    assert b.data[0].context == tmx.cpu() and b.label[0].context == tmx.cpu()
    assert b.data[0].shape == (2, 3, 8, 8)
