"""Image IO and augmentation on the host (counterpart of
mxnet_tpu/image.py; reference: python/mxnet/image/image.py).

`imdecode`, `imread`, `imresize`, the crop helpers, `color_normalize`,
every `Augmenter`, `CreateAugmenter` and `ImageIter`. Augmentation runs
in numpy on the host, as the reference runs it on the CPU through
OpenCV; PIL plays OpenCV's role. Random draws come from Python's global
`random` and numpy's global `np.random`, as the JAX package's do, so the
same seeds give the same crops, flips and jitters in both packages.

The functions and augmenters return NDArrays where the JAX package's
do, on the CPU context (the port's default context is the card): an
image stays a host array all through an iterator, and only the collated
batch is copied to the card, by the trainer that consumes it.
"""
from __future__ import annotations

import os
import random as _random

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array as _nd_array
from . import recordio
from .io import DataIter, DataBatch, DataDesc

__all__ = ["imdecode", "imresize", "scale_down", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "Augmenter", "SequentialAug", "RandomOrderAug",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "RandomSizedCropAug", "HorizontalFlipAug", "CastAug",
           "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "RandomGrayAug",
           "ColorJitterAug", "LightingAug",
           "ColorNormalizeAug", "CreateAugmenter", "ImageIter"]


def _np(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


def array(x):
    """A host (CPU) NDArray of `x`, with `nd.array`'s dtype rules
    (float64 becomes float32, int64 int32). A numpy array that owns its
    memory and keeps its dtype is wrapped without a copy (the augmenters
    hand over fresh arrays); anything else is copied."""
    if isinstance(x, np.ndarray) and x.base is None and \
            x.flags.c_contiguous and x.flags.writeable and \
            x.dtype not in (np.float64, np.int64) and \
            x.dtype.kind in "biuf":
        return NDArray(torch.from_numpy(x))
    return _nd_array(x, ctx=cpu())


def imdecode(buf, flag=1, to_rgb=1, out=None):
    """Decode an image byte buffer to an HWC NDArray
    (reference: image.py:imdecode, backed by src/io/image_io.cc).
    Delegates to recordio's decoder so .rec payloads decode identically
    on both paths."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    try:
        img = recordio._imdecode(bytes(buf), iscolor=1 if flag else 0)
    except RuntimeError as e:
        raise MXNetError(str(e)) from e
    if img.ndim == 2:
        img = img[:, :, None]
    return array(img)


def imread(filename, flag=1, to_rgb=1, out=None):
    """Read an image file to an HWC NDArray (reference: image.py imread,
    backed by the _cvimread op in src/io/image_io.cc)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb, out=out)


def copyMakeBorder(src, top, bot, left, right, fill_value=0):
    """Pad an HWC image with a constant border (reference: the
    _cvcopyMakeBorder op, src/io/image_io.cc)."""
    img = _np(src)
    out = np.pad(img, ((top, bot), (left, right), (0, 0)),
                 constant_values=fill_value)
    return array(out)


def imresize(src, w, h, interp=1):
    img = _np(src)
    try:
        from PIL import Image
        out = np.asarray(Image.fromarray(img.squeeze().astype(np.uint8))
                         .resize((w, h), Image.BILINEAR))
        if out.ndim == 2:
            out = out[:, :, None]
    except ImportError:
        # no PIL: torch's antialiased bilinear resize, half-pixel centres
        import torch
        import torch.nn.functional as F
        t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        t = t.reshape(img.shape[0], img.shape[1], -1).permute(2, 0, 1)
        t = F.interpolate(t[None], size=(h, w), mode="bilinear",
                          align_corners=False, antialias=True)[0]
        out = t.permute(1, 2, 0).reshape((h, w) + img.shape[2:]) \
            .numpy().astype(img.dtype)
    return array(out)


def scale_down(src_size, size):
    """Scale size down to fit in src_size (reference: image.py)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize the shorter edge to size (reference: image.py)."""
    img = _np(src)
    h, w = img.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    img = _np(src)
    out = img[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(array(out), size[0], size[1], interp)
    return array(out)


def random_crop(src, size, interp=2):
    img = _np(src)
    h, w = img.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = _random.randint(0, w - new_w)
    y0 = _random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    img = _np(src)
    h, w = img.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    img = _np(src)
    h, w = img.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _random.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(_random.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _random.randint(0, w - new_w)
            y0 = _random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    img = _np(src).astype(np.float32)
    img = img - _np(mean)
    if std is not None:
        img = img / _np(std)
    return array(img)


class Augmenter:
    """Image augmenter base (reference: image.py Augmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        _random.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _random.random() < self.p:
            return array(_np(src)[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return array(_np(src).astype(self.typ))


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.brightness, self.brightness)
        return array(_np(src).astype(np.float32) * alpha)


class ContrastJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.contrast, self.contrast)
        img = _np(src).astype(np.float32)
        gray = (img * self._coef).sum() * 3.0 / img.size
        return array(img * alpha + gray * (1 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.saturation, self.saturation)
        img = _np(src).astype(np.float32)
        gray = (img * self._coef).sum(axis=2, keepdims=True)
        return array(img * alpha + gray * (1 - alpha))


class HueJitterAug(Augmenter):
    """Random hue jitter via the RGB rotation approximation the
    reference uses (image.py HueJitterAug)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], np.float32)

    def __call__(self, src):
        alpha = _random.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]], np.float32)
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        return array(np.dot(_np(src).astype(np.float32), t))


class RandomGrayAug(Augmenter):
    """Randomly convert to grayscale (reference: image.py
    RandomGrayAug)."""

    _mat = np.array([[0.21, 0.21, 0.21],
                     [0.72, 0.72, 0.72],
                     [0.07, 0.07, 0.07]], np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _random.random() < self.p:
            return array(np.dot(_np(src).astype(np.float32), self._mat))
        return src


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,)) \
            .astype(np.float32)
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return array(_np(src).astype(np.float32) + rgb)


class ColorNormalizeAug(Augmenter):
    """(img - mean) / std in float32, per channel of an HWC image. The
    per-channel vectors are broadcast to the image's shape once a shape
    and kept: numpy's broadcast over a last axis of 3 runs an inner loop
    of 3, the same arithmetic on whole arrays runs ~9x faster, with the
    same bits."""

    _MAX_SHAPES = 8

    def __init__(self, mean, std):
        super().__init__()
        self.mean = np.asarray(mean, np.float32) \
            if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None
        self._full = {}

    def _broadcast(self, shape):
        full = self._full.get(shape)
        if full is None:
            if len(self._full) >= self._MAX_SHAPES:
                self._full = {}
            full = self._full[shape] = tuple(
                None if v is None else np.ascontiguousarray(
                    np.broadcast_to(v, shape)) for v in (self.mean, self.std))
        return full

    def __call__(self, src):
        img = _np(src)
        try:
            mean, std = self._broadcast(img.shape)
        except ValueError:          # not broadcastable: the plain form
            return color_normalize(src, self.mean, self.std)
        out = img.astype(np.float32)
        if mean is not None:
            np.subtract(out, mean, out=out)
        if std is not None:
            np.divide(out, std, out=out)
        return array(out)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Create an augmenter list (reference: image.py CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Image iterator with augmentation over .rec files or path lists
    (reference: image.py ImageIter; C++ twin iter_image_recordio_2.cc)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label",
                 part_index=0, num_parts=1, **kwargs):
        super().__init__(batch_size)
        assert len(data_shape) == 3
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.imgrec = None
        self.imglist = {}
        self.seq = []
        if path_imgrec:
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            self.imgrec = recordio.MXIndexedRecordIO(idx_path, path_imgrec,
                                                     "r")
            self.seq = list(self.imgrec.keys)
        elif path_imglist or imglist is not None:
            if path_imglist:
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        key = int(parts[0])
                        label = np.asarray(parts[1:-1], np.float32)
                        self.imglist[key] = (label, os.path.join(
                            path_root, parts[-1]))
                        self.seq.append(key)
            else:
                for i, rec in enumerate(imglist):
                    label = np.asarray(rec[0], np.float32).reshape(-1)
                    self.imglist[i] = (label, os.path.join(path_root,
                                                           rec[1]))
                    self.seq.append(i)
        else:
            raise MXNetError(
                "ImageIter needs path_imgrec, path_imglist or imglist")
        # dataset sharding across workers (reference: ImageIter's
        # part_index/num_parts): worker k keeps every n-th sample
        if not 0 <= int(part_index) < int(num_parts):
            raise MXNetError("part_index must be in [0, num_parts)")
        if int(num_parts) > 1:
            self.seq = self.seq[int(part_index)::int(num_parts)]
        if aug_list is None:
            aug_list = CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize",
                         "rand_mirror", "mean", "std", "brightness",
                         "contrast", "saturation", "hue", "pca_noise",
                         "rand_gray", "inter_method")})
        self.auglist = aug_list
        self.cur = 0
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, label_width)
                                       if label_width > 1
                                       else (batch_size,))]
        self.reset()

    def reset(self):
        if self.shuffle:
            _random.shuffle(self.seq)
        self.cur = 0
        if self.imgrec is not None:
            self.imgrec.reset()

    def next_sample(self):
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            s = self.imgrec.read_idx(idx)
            header, img = recordio.unpack(s)
            label = header.label
            return label, img
        label, fname = self.imglist[idx]
        with open(fname, "rb") as f:
            return label, f.read()

    def next(self):
        batch_data = np.zeros((self.batch_size,) + self.data_shape,
                              np.float32)
        lshape = self.provide_label[0].shape
        batch_label = np.zeros(lshape, np.float32)
        i = 0
        pad = 0
        try:
            while i < self.batch_size:
                label, s = self.next_sample()
                img = imdecode(s)
                for aug in self.auglist:
                    img = aug(img)
                arr = _np(img)
                batch_data[i] = arr.transpose(2, 0, 1)
                batch_label[i] = np.asarray(label, np.float32).reshape(
                    batch_label[i].shape) if self.label_width > 1 \
                    else float(np.asarray(label).ravel()[0])
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = self.batch_size - i
        return DataBatch(data=[array(batch_data)],
                         label=[array(batch_label)], pad=pad,
                         index=None)


# detection pipeline (reference: python/mxnet/image/detection.py is
# re-exported through the mx.image namespace); imported last to avoid
# a cycle — image_det uses this module's augmenters/decoders
from .image_det import (  # noqa: E402,F401
    DetAugmenter, DetBorrowAug, DetRandomSelectAug,
    DetHorizontalFlipAug, DetRandomCropAug, DetRandomPadAug,
    CreateMultiRandCropAugmenter, CreateDetAugmenter, ImageDetIter)
