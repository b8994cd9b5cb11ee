"""Vision transforms (counterpart of
mxnet_tpu/gluon/data/vision/transforms.py): Compose, Cast, ToTensor,
Normalize, Resize, CenterCrop, RandomResizedCrop, RandomFlipLeftRight,
RandomFlipTopBottom, RandomBrightness, RandomContrast, RandomSaturation,
RandomHue, RandomColorJitter, RandomLighting.

They run on the host, in the DataLoader's workers or the parent: an
image (HWC) comes in as an NDArray or numpy array and goes out as an
NDArray on the input's context (the CPU for numpy), so nothing in a
worker reaches the card. The random ones draw from Python's `random`
and numpy's generator, as the JAX package's do.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from ....ndarray import NDArray
from ...block import Block, HybridBlock
from ...nn import HybridSequential, Sequential

__all__ = ["CenterCrop", "Cast", "Compose", "Normalize", "RandomBrightness",
           "RandomColorJitter", "RandomContrast", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomHue", "RandomLighting",
           "RandomResizedCrop", "RandomSaturation", "Resize", "ToTensor"]


def _to_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def _like(arr, x):
    """`arr` (numpy) as an NDArray where `x` lives (the CPU for numpy)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return NDArray(t.to(x._data.device) if isinstance(x, NDArray) else t)


def _clip(out, dtype):
    return np.clip(out, 0, 255 if dtype == np.uint8 else np.inf) \
        .astype(dtype)


class Compose(Sequential):
    """transforms.py:33: applies the transforms in order; runs of
    HybridBlocks are grouped in a HybridSequential, as in Gluon."""

    def __init__(self, transforms):
        super().__init__()
        transforms = list(transforms) + [None]
        hybrid = []
        for t in transforms:
            if isinstance(t, HybridBlock):
                hybrid.append(t)
                continue
            if len(hybrid) == 1:
                self.add(hybrid[0])
            elif len(hybrid) > 1:
                hblock = HybridSequential()
                for h in hybrid:
                    hblock.add(h)
                self.add(hblock)
            hybrid = []
            if t is not None:
                self.add(t)


class Cast(HybridBlock):
    """transforms.py:70: casts to `dtype`."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = getattr(torch, str(dtype))

    def forward(self, x):
        return x.to(self._dtype)


class ToTensor(HybridBlock):
    """transforms.py:88: HWC (or NHWC) uint8 in [0, 255] -> CHW (NCHW)
    float32 in [0, 1]."""

    def forward(self, x):
        x = x.to(torch.float32)
        perm = (2, 0, 1) if x.dim() == 3 else (0, 3, 1, 2)
        return x.permute(*perm) / 255.0


class Normalize(Block):
    """transforms.py:111: (x - mean) / std per channel of a CHW image."""

    def __init__(self, mean, std):
        super().__init__()
        self._mean = torch.as_tensor(np.asarray(mean, np.float32)
                                     .reshape(-1, 1, 1))
        self._std = torch.as_tensor(np.asarray(std, np.float32)
                                    .reshape(-1, 1, 1))

    def forward(self, x):
        return (x - self._mean.to(x.device)) / self._std.to(x.device)


class _HostTransform(Block):
    """A transform of a numpy HWC image."""

    _ndarray_forward = True

    def forward(self, x):
        return _like(self._apply(_to_np(x)), x)

    def _apply(self, img):
        raise NotImplementedError


def _resize(img, nh, nw):
    """Bilinear resize of an HWC image to (nh, nw): PIL's where it is
    installed (as the JAX package), else PyTorch's antialiased one."""
    try:
        from PIL import Image
    except ImportError:
        t = torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)[None]
        out = torch.nn.functional.interpolate(
            t, size=(nh, nw), mode="bilinear", align_corners=False,
            antialias=True)[0].permute(1, 2, 0).numpy()
        if img.dtype == np.uint8:
            out = np.clip(np.rint(out), 0, 255)
        return out.astype(img.dtype)
    squeeze = img.ndim == 3 and img.shape[2] == 1
    src = img[:, :, 0] if squeeze else img
    out = np.asarray(Image.fromarray(src.astype(np.uint8)).resize(
        (nw, nh), Image.BILINEAR))
    return out[:, :, None] if out.ndim == 2 else out


class Resize(_HostTransform):
    """transforms.py:139: to `size` (an int: square, or the shorter side
    with `keep_ratio`; else (w, h))."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def _apply(self, img):
        h, w = img.shape[:2]
        if isinstance(self._size, int):
            if self._keep:
                if h < w:
                    nh, nw = self._size, int(w * self._size / h)
                else:
                    nh, nw = int(h * self._size / w), self._size
            else:
                nh = nw = self._size
        else:
            nw, nh = self._size
        return _resize(img, nh, nw)


class CenterCrop(_HostTransform):
    """transforms.py:268: the central (w, h) crop."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def _apply(self, img):
        h, w = img.shape[:2]
        cw, ch = self._size
        x0 = max((w - cw) // 2, 0)
        y0 = max((h - ch) // 2, 0)
        return img[y0:y0 + ch, x0:x0 + cw]


class RandomResizedCrop(_HostTransform):
    """transforms.py:220: a crop of random area and aspect ratio,
    resized to `size`."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def _apply(self, img):
        h, w = img.shape[:2]
        area = h * w
        nw, nh = self._size
        for _ in range(10):
            target_area = random.uniform(*self._scale) * area
            aspect = random.uniform(*self._ratio)
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x0 = random.randint(0, w - cw)
                y0 = random.randint(0, h - ch)
                return _resize(img[y0:y0 + ch, x0:x0 + cw], nh, nw)
        return _resize(img, nh, nw)


class RandomFlipLeftRight(_HostTransform):
    """transforms.py:301: a horizontal flip with probability 0.5."""

    def _apply(self, img):
        return img[:, ::-1].copy() if random.random() < 0.5 else img


class RandomFlipTopBottom(_HostTransform):
    """transforms.py:312: a vertical flip with probability 0.5."""

    def _apply(self, img):
        return img[::-1].copy() if random.random() < 0.5 else img


class RandomBrightness(_HostTransform):
    """transforms.py:323: x * U(1 - b, 1 + b)."""

    def __init__(self, brightness):
        super().__init__()
        self._args = max(0, 1 - brightness), 1 + brightness

    def _apply(self, img):
        alpha = random.uniform(*self._args)
        return _clip(img.astype(np.float32) * alpha, img.dtype)


class RandomContrast(_HostTransform):
    """transforms.py:340: gray + U(1 - c, 1 + c) * (x - gray), gray the
    image mean."""

    def __init__(self, contrast):
        super().__init__()
        self._args = max(0, 1 - contrast), 1 + contrast

    def _apply(self, img):
        alpha = random.uniform(*self._args)
        x = img.astype(np.float32)
        gray = x.mean()
        return _clip(gray + alpha * (x - gray), img.dtype)


class RandomSaturation(_HostTransform):
    """transforms.py:357: gray + U(1 - s, 1 + s) * (x - gray), gray the
    pixel's channel mean."""

    def __init__(self, saturation):
        super().__init__()
        self._args = max(0, 1 - saturation), 1 + saturation

    def _apply(self, img):
        alpha = random.uniform(*self._args)
        x = img.astype(np.float32)
        gray = x.mean(axis=2, keepdims=True)
        return _clip(gray + alpha * (x - gray), img.dtype)


class RandomHue(_HostTransform):
    """transforms.py:407: a rotation of the YIQ chroma plane by
    U(-h, h) * pi."""

    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def _apply(self, img):
        alpha = random.uniform(-self._hue, self._hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], np.float32)
        t_rgb = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], np.float32)
        rot = np.array([[1, 0, 0], [0, u, -w], [0, w, u]], np.float32)
        m = t_rgb @ rot @ t_yiq
        return _clip(img.astype(np.float32) @ m.T, img.dtype)


class RandomColorJitter(_HostTransform):
    """transforms.py:391: brightness, contrast, saturation and hue
    jitter, in a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def _apply(self, img):
        ts = list(self._ts)
        random.shuffle(ts)
        for t in ts:
            img = t._apply(img)
        return img


class RandomLighting(_HostTransform):
    """transforms.py:415: AlexNet's PCA lighting noise, N(0, alpha) along
    the ImageNet RGB eigenvectors."""

    _eigval = np.array([55.46, 4.794, 1.148], dtype=np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], dtype=np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def _apply(self, img):
        alpha = np.random.normal(0, self._alpha, size=(3,)) \
            .astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return _clip(img.astype(np.float32) + rgb, img.dtype)

