"""The detection data pipeline: label-aware augmenters and ImageDetIter
(counterpart of mxnet_tpu/image_det.py; reference:
python/mxnet/image/detection.py and src/io/iter_image_det_recordio.cc).

Host-side numpy augmentation feeding fixed-shape (batch, max_objects,
label_width) label tensors padded with -1, so the consumer sees one
static shape per dataset. Labels follow the reference's convention: a
flat per-image array [header_w, obj_w, <extra header...>, obj0, obj1,
...], each object [class_id, xmin, ymin, xmax, ymax, ...] with
coordinates normalized to [0, 1]; `ImageDetIter` strips the header and
emits object rows only. Draws come from Python's global `random`, as
the JAX package's do; images are host NDArrays (`image.array`).
"""
from __future__ import annotations

import json
import math
import random as pyrandom

import numpy as np

from .base import MXNetError
from .io import DataBatch, DataDesc
from . import image as _img

array = _img.array

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
           "ImageDetIter"]


# ---------------------------------------------------------------------------
# box helpers (vectorized over object rows [id, x1, y1, x2, y2, ...])
# ---------------------------------------------------------------------------
def _box_areas(boxes):
    return (np.maximum(0.0, boxes[:, 3] - boxes[:, 1])
            * np.maximum(0.0, boxes[:, 4] - boxes[:, 2]))


def _coverage_in_window(objs, x1, y1, x2, y2):
    """Fraction of each object's area inside the window (normalized
    coords)."""
    ix1 = np.maximum(objs[:, 1], x1)
    iy1 = np.maximum(objs[:, 2], y1)
    ix2 = np.minimum(objs[:, 3], x2)
    iy2 = np.minimum(objs[:, 4], y2)
    inter = (np.maximum(0.0, ix2 - ix1) * np.maximum(0.0, iy2 - iy1))
    area = _box_areas(objs)
    with np.errstate(divide="ignore", invalid="ignore"):
        cov = np.where(area > 0, inter / np.maximum(area, 1e-12), 0.0)
    return cov


def _remap_boxes(objs, x0, y0, w, h, min_keep):
    """Re-express boxes in a window's coordinate frame, clip to it, and
    drop objects whose surviving area fraction <= min_keep. Returns
    None when nothing survives (the proposal should be rejected)."""
    out = objs.copy()
    before = _box_areas(objs)
    out[:, (1, 3)] = (out[:, (1, 3)] - x0) / w
    out[:, (2, 4)] = (out[:, (2, 4)] - y0) / h
    out[:, 1:5] = np.clip(out[:, 1:5], 0.0, 1.0)
    after = _box_areas(out) * w * h
    with np.errstate(divide="ignore", invalid="ignore"):
        keep_frac = np.where(before > 0, after / np.maximum(before, 1e-12),
                             0.0)
    alive = ((out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
             & (keep_frac > min_keep))
    if not alive.any():
        return None
    return out[alive]


# ---------------------------------------------------------------------------
# augmenters
# ---------------------------------------------------------------------------
class DetAugmenter:
    """Base detection augmenter: __call__(src, label) -> (src, label)
    (reference: detection.py:39)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, np.ndarray):
                kwargs[k] = v.tolist()

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline: the
    label rides through untouched (reference: detection.py:65)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def dumps(self):
        return [self.__class__.__name__.lower(), self.augmenter.dumps()]

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Pick one augmenter at random per sample — or none, with
    probability skip_prob (reference: detection.py:90)."""

    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def dumps(self):
        return [self.__class__.__name__.lower(),
                [a.dumps() for a in self.aug_list]]

    def __call__(self, src, label):
        if not self.aug_list or pyrandom.random() < self.skip_prob:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image AND x-coordinates with probability p
    (reference: detection.py:126)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = array(_img._np(src)[:, ::-1].copy())
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """IoU-constrained random crop: propose (ratio, area) windows until
    one covers every visible object by at least min_object_covered;
    objects whose surviving area fraction is below min_eject_coverage
    are dropped from the label (reference: detection.py:152, the
    SSD-style sampler)."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self.enabled = area_range[1] > area_range[0] > 0

    def _propose(self, height, width):
        """One (x, y, w, h) pixel window honoring ratio + area ranges,
        or None when geometry can't be satisfied."""
        ratio = pyrandom.uniform(*self.aspect_ratio_range)
        if ratio <= 0:
            return None
        lo_a = self.area_range[0] * height * width
        hi_a = self.area_range[1] * height * width
        h_lo = int(round(math.sqrt(lo_a / ratio)))
        h_hi = min(int(round(math.sqrt(hi_a / ratio))),
                   height, int(width / ratio))
        if h_hi < 1 or h_lo > h_hi:
            return None
        h = pyrandom.randint(max(1, h_lo), h_hi)
        w = int(round(h * ratio))
        if w > width or w < 1 or not lo_a <= w * h <= hi_a * 1.01:
            return None
        return (pyrandom.randint(0, width - w),
                pyrandom.randint(0, height - h), w, h)

    def __call__(self, src, label):
        if not self.enabled:
            return src, label
        height, width = src.shape[0], src.shape[1]
        if height <= 0 or width <= 0:
            return src, label
        for _ in range(self.max_attempts):
            prop = self._propose(height, width)
            if prop is None:
                continue
            x, y, w, h = prop
            if w * h < 2:
                continue
            wx1, wy1 = x / width, y / height
            wx2, wy2 = (x + w) / width, (y + h) / height
            areas = _box_areas(label) * width * height
            visible = label[areas > 2]
            if visible.shape[0] < 1:
                return src, label
            # NOTE: zero-coverage objects are excluded before the min, so a
            # window may entirely exclude an object and still satisfy
            # min_object_covered; those objects are then dropped by
            # _remap_boxes. This matches the reference sampler exactly
            # (detection.py:249-250 filters `coverages > 0` the same way) —
            # the constraint governs partially-visible objects only.
            cov = _coverage_in_window(visible, wx1, wy1, wx2, wy2)
            cov = cov[cov > 0]
            if cov.size == 0 or cov.min() <= self.min_object_covered:
                continue
            new_label = _remap_boxes(label, wx1, wy1, wx2 - wx1,
                                     wy2 - wy1, self.min_eject_coverage)
            if new_label is None:
                continue
            return _img.fixed_crop(src, x, y, w, h, None), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random expand: place the image on a larger canvas and shrink the
    boxes into it (reference: detection.py:324)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val
        self.enabled = area_range[1] > 1.0

    def __call__(self, src, label):
        height, width = src.shape[0], src.shape[1]
        if not self.enabled or height <= 0 or width <= 0:
            return src, label
        for _ in range(self.max_attempts):
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            area = pyrandom.uniform(*self.area_range)
            if ratio <= 0 or area < 1.0:
                continue
            nh = int(round(math.sqrt(area * height * width / ratio)))
            nw = int(round(nh * ratio))
            if nh < height or nw < width:
                continue
            y0 = pyrandom.randint(0, nh - height)
            x0 = pyrandom.randint(0, nw - width)
            arr = _img._np(src)
            canvas = np.empty((nh, nw, src.shape[2]), dtype=arr.dtype)
            canvas[:] = np.asarray(self.pad_val, arr.dtype)
            canvas[y0:y0 + height, x0:x0 + width] = arr
            out = label.copy()
            out[:, (1, 3)] = (out[:, (1, 3)] * width + x0) / nw
            out[:, (2, 4)] = (out[:, (2, 4)] * height + y0) / nh
            return array(canvas), out
        return src, label


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """A DetRandomSelectAug over several crop samplers, one per
    parameter combination (reference: detection.py:418). Scalar
    arguments broadcast against the longest list."""
    def as_list(x):
        return list(x) if isinstance(x, (list, tuple)) and x and \
            isinstance(x[0], (list, tuple)) else [x]

    packs = [as_list(min_object_covered), as_list(aspect_ratio_range),
             as_list(area_range), as_list(min_eject_coverage),
             as_list(max_attempts)]
    # broadcast scalars/singletons to the longest parameter list
    n = max(len(p) for p in packs)
    for p in packs:
        if len(p) not in (1, n):
            raise MXNetError(
                "CreateMultiRandCropAugmenter: parameter lists must "
                "share a length (or be scalar), got %d vs %d"
                % (len(p), n))
        while len(p) < n:
            p.append(p[0])
    crops = [DetRandomCropAug(min_object_covered=packs[0][i],
                              aspect_ratio_range=packs[1][i],
                              area_range=packs[2][i],
                              min_eject_coverage=packs[3][i],
                              max_attempts=packs[4][i])
             for i in range(n)]
    return DetRandomSelectAug(crops, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None,
                       std=None, brightness=0, contrast=0, saturation=0,
                       pca_noise=0, hue=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard detection augmentation stack (reference:
    detection.py:483): geometric label-aware ops + color ops borrowed
    from the classification pipeline + forced resize to data_shape."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(_img.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = CreateMultiRandCropAugmenter(
            min_object_covered=min_object_covered,
            aspect_ratio_range=aspect_ratio_range,
            area_range=(area_range[0], min(1.0, area_range[1])),
            min_eject_coverage=min_eject_coverage,
            max_attempts=max_attempts, skip_prob=1 - rand_crop)
        auglist.append(crop)
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    # force to the network's input size LAST so labels stay normalized
    auglist.append(DetBorrowAug(_img.ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    color_augs = []
    if brightness or contrast or saturation:
        color_augs.append(_img.ColorJitterAug(brightness, contrast,
                                              saturation))
    if hue:
        color_augs.append(_img.HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.814],
                           [-0.5836, -0.6948, 0.4203]])
        color_augs.append(_img.LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        color_augs.append(_img.RandomGrayAug(rand_gray))
    auglist.extend(DetBorrowAug(a) for a in color_augs)
    auglist.append(DetBorrowAug(_img.CastAug()))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(DetBorrowAug(_img.ColorNormalizeAug(mean, std)))
    return auglist


# ---------------------------------------------------------------------------
# iterator
# ---------------------------------------------------------------------------
class ImageDetIter(_img.ImageIter):
    """Detection iterator over .rec files or image lists: decodes,
    applies label-aware augmentation, and emits fixed-shape
    (batch, max_objects, label_width) labels padded with -1
    (reference: detection.py:625; C++ twin
    src/io/iter_image_det_recordio.cc)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="label", part_index=0, num_parts=1,
                 **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_pad", "rand_gray",
                         "rand_mirror", "mean", "std", "brightness",
                         "contrast", "saturation", "pca_noise", "hue",
                         "inter_method", "min_object_covered",
                         "aspect_ratio_range", "area_range",
                         "min_eject_coverage", "max_attempts",
                         "pad_val")})
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         shuffle=shuffle, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         part_index=part_index, num_parts=num_parts)
        self.det_auglist = aug_list
        max_objects, label_width = self._scan_label_shape()
        self.max_objects = max_objects
        self.label_width = label_width
        self.label_shape = (max_objects, label_width)
        self.provide_label = [DataDesc(
            label_name, (batch_size, max_objects, label_width))]

    # -- label plumbing -------------------------------------------------
    @staticmethod
    def _object_rows(label):
        """Strip the [header_w, obj_w, extra...] header and return the
        (N, obj_w) object matrix (reference: detection.py:710)."""
        raw = np.asarray(label, np.float32).ravel()
        if raw.size < 7:
            raise MXNetError(
                "detection label too short (%d floats): need header "
                "[A, B, ...] plus at least one [id, x1, y1, x2, y2] "
                "object" % raw.size)
        header_w = int(raw[0])
        obj_w = int(raw[1])
        if header_w < 2 or obj_w < 5:
            raise MXNetError(
                "invalid detection label header (A=%d, B=%d)"
                % (header_w, obj_w))
        body = raw[header_w:]
        n = body.size // obj_w
        if n < 1:
            raise MXNetError("detection label carries no objects")
        return body[:n * obj_w].reshape(n, obj_w)

    def _scan_label_shape(self):
        """One pass over the dataset to size the padded label tensor
        (reference: detection.py:696 _estimate_label_shape)."""
        max_obj, width = 0, 5
        self.reset()
        while True:
            try:
                label, _ = self.next_sample()
            except StopIteration:
                break
            objs = self._object_rows(label)
            max_obj = max(max_obj, objs.shape[0])
            width = max(width, objs.shape[1])
        self.reset()
        if max_obj == 0:
            raise MXNetError("ImageDetIter: empty dataset")
        return max_obj, width

    def _check_valid_label(self, label):
        """Shape/coordinate sanity for one padded label
        (reference: detection.py:686)."""
        if label.ndim != 2 or label.shape[1] < 5:
            raise MXNetError("label must be (N, >=5), got %s"
                             % (label.shape,))
        real = label[label[:, 0] >= 0]
        if ((real[:, 1:5] < -0.01).any()
                or (real[:, 1:5] > 1.01).any()
                or (real[:, 3] <= real[:, 1]).any()
                or (real[:, 4] <= real[:, 2]).any()):
            raise MXNetError("invalid box coordinates in label")

    def check_label_shape(self, label_shape):
        """Validate a user-supplied label_shape (reference:
        detection.py:793)."""
        if len(label_shape) != 2 or label_shape[1] < self.label_width \
                or label_shape[0] < self.max_objects:
            raise MXNetError(
                "label_shape %s too small for dataset needing (%d, %d)"
                % (label_shape, self.max_objects, self.label_width))

    def reshape(self, data_shape=None, label_shape=None):
        """Resize the padded output shapes (reference:
        detection.py:736)."""
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
            self.provide_data = [DataDesc(
                self.provide_data[0].name,
                (self.batch_size,) + self.data_shape)]
        if label_shape is not None:
            self.check_label_shape(label_shape)
            self.max_objects, self.label_width = label_shape
            self.label_shape = tuple(label_shape)
            self.provide_label = [DataDesc(
                self.provide_label[0].name,
                (self.batch_size,) + tuple(label_shape))]

    def sync_label_shape(self, it, verbose=False):
        """Unify label shapes of train/val iterators (reference:
        detection.py:901)."""
        assert isinstance(it, ImageDetIter)
        shape = (max(self.max_objects, it.max_objects),
                 max(self.label_width, it.label_width))
        self.reshape(label_shape=shape)
        it.reshape(label_shape=shape)
        return it

    def augmentation_transform(self, data, label):
        """Apply the detection augmenter chain (reference:
        detection.py:787)."""
        for aug in self.det_auglist:
            data, label = aug(data, label)
        return data, label

    # -- batching -------------------------------------------------------
    def next(self):
        bs = self.batch_size
        batch_data = np.zeros((bs,) + self.data_shape, np.float32)
        batch_label = np.full((bs, self.max_objects, self.label_width),
                              -1.0, np.float32)
        i = pad = 0
        try:
            while i < bs:
                raw_label, s = self.next_sample()
                img = _img.imdecode(s)
                objs = self._object_rows(raw_label)
                img, objs = self.augmentation_transform(img, objs)
                n = min(objs.shape[0], self.max_objects)
                batch_label[i, :n, :objs.shape[1]] = objs[:n]
                self._check_valid_label(batch_label[i])
                arr = np.asarray(_img._np(img), np.float32)
                batch_data[i] = arr.transpose(2, 0, 1)
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = bs - i
        return DataBatch(data=[array(batch_data)],
                         label=[array(batch_label)], pad=pad, index=None)

    def draw_next(self, color=None, thickness=2, mean=None, std=None,
                  clip=True, waitKey=None, window_name=None,
                  id2labels=None):
        """Yield augmented images with boxes burned in as numpy arrays
        (reference: detection.py:806 — theirs renders via cv2; this
        draws rectangle outlines directly)."""
        while True:
            try:
                raw_label, s = self.next_sample()
            except StopIteration:
                return
            img = _img.imdecode(s)
            objs = self._object_rows(raw_label)
            img, objs = self.augmentation_transform(img, objs)
            arr = np.asarray(_img._np(img), np.float32).copy()
            h, w = arr.shape[0], arr.shape[1]
            col = np.asarray(color if color is not None
                             else (255, 0, 0), np.float32)
            for row in objs:
                if row[0] < 0:
                    continue
                x1 = int(np.clip(row[1], 0, 1) * (w - 1))
                y1 = int(np.clip(row[2], 0, 1) * (h - 1))
                x2 = int(np.clip(row[3], 0, 1) * (w - 1))
                y2 = int(np.clip(row[4], 0, 1) * (h - 1))
                t = max(1, int(thickness))
                arr[y1:y1 + t, x1:x2 + 1] = col
                arr[max(0, y2 - t + 1):y2 + 1, x1:x2 + 1] = col
                arr[y1:y2 + 1, x1:x1 + t] = col
                arr[y1:y2 + 1, max(0, x2 - t + 1):x2 + 1] = col
            yield arr
